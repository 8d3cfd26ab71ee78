"""The fused dual matvec of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version (the CUDA
kernel is checked against that same version on the card by
``chip_smoke.py``). Here it is held against the Pallas kernel in
interpret mode and the JAX reference, at the shapes of
``tests/test_pallas.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from totsu_tpu.ops.pallas.dual_matvec import (
    dual_matvec_f32, dual_matvec_reference,
)
from totsu_tpu_torch.ops.kernels import _build
from totsu_tpu_torch.ops.kernels import dual_matvec as dm

SHAPES = [(256, 128), (173, 77), (8, 128), (300, 500)]


def _data(m, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, n)).astype(dtype),
            rng.normal(size=n).astype(dtype),
            rng.normal(size=m).astype(dtype))


@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_matches_pallas_interpret_f32(m, n):
    # f32 sums in different orders: rtol 2e-4 as in test_pallas.py
    a, u, v = _data(m, n, 0)
    pj, qj = dual_matvec_f32(jnp.asarray(a), jnp.asarray(u), jnp.asarray(v),
                             interpret=True)
    pr, qr = dual_matvec_reference(jnp.asarray(a), jnp.asarray(u),
                                   jnp.asarray(v))
    before = dm.launches
    p, q = dm.dual_matvec(torch.from_numpy(a), torch.from_numpy(u),
                          torch.from_numpy(v))
    assert dm.launches == before  # the plain version is not a launch
    assert p.dtype == q.dtype == torch.float32
    for got, want in ((p, pj), (q, qj), (p, pr), (q, qr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=1e-4)


def test_bf16_storage_matches_rounded_matrix():
    # bf16 storage: both packages round A the same way (exactly), and the
    # products match the f32 products of the rounded matrix
    a, u, v = _data(173, 77, 2)
    a_bf_j = jnp.asarray(a).astype(jnp.bfloat16)
    a_bf_t = torch.from_numpy(a).to(torch.bfloat16)
    rounded = np.asarray(a_bf_j.astype(jnp.float32))
    np.testing.assert_array_equal(a_bf_t.to(torch.float32).numpy(), rounded)
    pj, qj = dual_matvec_f32(a_bf_j, jnp.asarray(u), jnp.asarray(v),
                             interpret=True)
    p, q = dm.dual_matvec(a_bf_t, torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(p.numpy(), rounded @ u, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), v @ rounded, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=2e-4,
                               atol=1e-4)


@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_matches_reference_f64(m, n):
    a, u, v = _data(m, n, 1, np.float64)
    pr, qr = dual_matvec_reference(jnp.asarray(a), jnp.asarray(u),
                                   jnp.asarray(v))
    p, q = dm.dual_matvec(torch.from_numpy(a), torch.from_numpy(u),
                          torch.from_numpy(v))
    assert p.dtype == q.dtype == torch.float64
    np.testing.assert_allclose(p.numpy(), np.asarray(pr), rtol=0, atol=1e-10)
    np.testing.assert_allclose(q.numpy(), np.asarray(qr), rtol=0, atol=1e-10)


def test_wrapper_checks_types_and_shapes():
    a, u, v = (torch.from_numpy(x) for x in _data(8, 4, 3))
    with pytest.raises(TypeError, match="needs torch.float32 vectors"):
        dm.dual_matvec(a, u.double(), v)
    with pytest.raises(TypeError, match="f32, bf16 or f64"):
        dm.dual_matvec(a.half(), u, v)
    with pytest.raises(ValueError, match="with u"):
        dm.dual_matvec(a, v, u)


def test_no_fallback_off_cpu():
    # a tensor that is neither on the CPU nor on a CUDA device is refused,
    # and the CUDA entry point refuses CPU tensors: the plain version runs
    # only because a tensor lies on the CPU
    a, u, v = (torch.from_numpy(x) for x in _data(8, 4, 4))
    meta = [t.to("meta") for t in (a, u, v)]
    with pytest.raises(ValueError, match="unsupported device"):
        dm.dual_matvec(*meta)
    with pytest.raises(ValueError, match="CUDA device"):
        dm.dual_matvec_cuda(a, u, v)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    # no toolkit: the build raises instead of falling back
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("dual_matvec")


def test_library_is_keyed_on_source_hash():
    p1 = _build.library_path("dual_matvec")
    p2 = _build.library_path("megakernel")
    assert p1.parent == p2.parent == _build.BUILD_DIR
    assert p1.name.startswith("dual_matvec-") and p1.suffix == ".so"
    assert p1 == _build.library_path("dual_matvec")
