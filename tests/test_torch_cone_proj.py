"""The blocked exp/pow projection wrapper (``ops/kernels/cone_proj.py``).

On the CPU the wrapper runs its plain version, the PyTorch cores of
``solver/cone.py``, which ``tests/test_torch_cones.py`` holds against the
JAX package; the CUDA kernel is held against the same plain version on the
card by ``chip_smoke.py``. Here: the dispatch, the Moreau dual, the
per-block exponent, the input checks, the launch count and the build key.
"""

import shutil

import numpy as np
import pytest
import torch

from totsu_tpu_torch.ops.kernels import _build
from totsu_tpu_torch.ops.kernels import cone_proj as cp
from totsu_tpu_torch.solver import cone as tcone


def _blocks(count=50, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    scale = rng.choice([1e-3, 1.0, 1e3], size=(count, 1))
    return torch.tensor(rng.normal(size=(count, 3)) * scale, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
@pytest.mark.parametrize("kind,alpha", [("exp", 0.0), ("pow", 0.1),
                                        ("pow", 0.3), ("pow", 0.5),
                                        ("pow", 0.9)])
def test_cpu_path_is_the_plain_version(kind, alpha, dual, dtype):
    # bit for bit: the wrapper runs the plain version for a CPU tensor,
    # which is the cores of solver/cone.py (the dual by the Moreau
    # identity x + proj_K(-x)), and launches nothing
    xb = _blocks(dtype=dtype)
    before = cp.launches
    got = cp.cone_proj(xb, kind, alpha, dual)
    assert cp.launches == before
    if kind == "exp":
        proj = tcone._proj_exp_blocks
    else:
        def proj(x):
            return tcone._proj_pow_blocks(x, alpha)
    want = xb + proj(-xb) if dual else proj(xb)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(cp.cone_proj_plain(xb, kind, alpha, dual),
                               want, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["exp", "pow"])
def test_layout_projection_goes_through_the_wrapper(kind, monkeypatch):
    # ConeLayout.project hands each exp/pow factor to the wrapper once,
    # with the factor's exponent and the dual flag
    calls = []
    real = cp.cone_proj
    monkeypatch.setattr(cp, "cone_proj", lambda *a: calls.append(a[1:])
                        or real(*a))
    f = tcone.expc(4) if kind == "exp" else tcone.powc(0.3, 4)
    lay = tcone.ConeLayout([tcone.rpos(2), f, tcone.soc(3)])
    x = torch.from_numpy(np.random.default_rng(1).normal(size=lay.dim))
    out = lay.project(x, dual=True)
    assert calls == [(kind, f.alpha, True)]
    torch.testing.assert_close(out[2:14], real(x[2:14].reshape(4, 3), kind,
                                               f.alpha, True).reshape(12),
                               rtol=0, atol=0)


def test_per_block_alpha():
    xb = _blocks(40, seed=2)
    alphas = torch.tensor(np.repeat([0.1, 0.3, 0.5, 0.9], 10))
    for dual in (False, True):
        got = cp.cone_proj(xb, "pow", alphas, dual)
        for k, a in enumerate((0.1, 0.3, 0.5, 0.9)):
            rows = slice(10 * k, 10 * k + 10)
            torch.testing.assert_close(
                got[rows], cp.cone_proj(xb[rows], "pow", a, dual), rtol=0,
                atol=0)


@pytest.mark.parametrize("args,err,match", [
    ((torch.zeros(4, 2), "exp"), ValueError, r"\(count, 3\)"),
    ((torch.zeros(4, 3), "soc"), ValueError, "'exp' or 'pow'"),
    ((torch.zeros(4, 3, dtype=torch.float16), "exp"), TypeError, "f32 or f64"),
    ((torch.zeros(4, 3), "pow", 1.0), ValueError, "alpha must be in"),
    ((torch.zeros(4, 3), "pow", torch.full((3,), 0.5)), ValueError,
     "per-block alpha"),
    ((torch.zeros(4, 3), "pow", torch.full((4,), 0.5, dtype=torch.float64)),
     ValueError, "per-block alpha"),
], ids=["shape", "kind", "dtype", "alpha_range", "alpha_shape",
        "alpha_dtype"])
def test_wrapper_checks_inputs(args, err, match):
    with pytest.raises(err, match=match):
        cp.cone_proj(*args)


def test_no_fallback_off_cpu():
    # a tensor neither on the CPU nor on a CUDA device is refused, and the
    # CUDA entry point refuses CPU tensors
    xb = _blocks(4)
    with pytest.raises(ValueError, match="unsupported device"):
        cp.cone_proj(xb.to("meta"), "exp")
    with pytest.raises(ValueError, match="CUDA device"):
        cp.cone_proj_cuda(xb, "exp")
    with pytest.raises(ValueError, match="CUDA device"):
        cp.cone_proj_cuda(xb, "pow", 0.5, dual=True)


def test_empty_factor():
    xb = torch.zeros(0, 3, dtype=torch.float64)
    for kind in ("exp", "pow"):
        assert cp.cone_proj(xb, kind, 0.5).shape == (0, 3)


def test_library_key_covers_the_shared_header(monkeypatch, tmp_path):
    # both kernels include csrc/cone_exppow.cuh: an edited header must give
    # new library paths, an unrelated source must not move them
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n)
              for n in ("cone_proj", "megakernel", "dual_matvec")}
    header = csrc / "cone_exppow.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert after["cone_proj"] != before["cone_proj"]
    assert after["megakernel"] != before["megakernel"]
    (csrc / "cone_proj.cu").write_text(
        (csrc / "cone_proj.cu").read_text() + "\n")
    assert _build.library_path("megakernel") == after["megakernel"]
    assert _build.library_path("cone_proj") != after["cone_proj"]


def test_sources_include_the_shared_header():
    for name in ("cone_proj", "megakernel"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "cone_exppow.cuh"' in src


def test_build_starts_every_nvcc_together(monkeypatch, tmp_path):
    # a stand-in compiler that takes a second and writes its -o file: the
    # three builds overlap, each leaves its log and library, and a second
    # call finds them built
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nsleep 1\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then echo built > \"$2\"; fi\n"
                    "  shift\ndone\necho ptxas info\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_seconds", {})
    names = ("dual_matvec", "megakernel", "cone_proj")
    _build.build(names)
    for name in names:
        assert _build.library_path(name).read_text() == "built\n"
        assert "ptxas info" in _build.library_path(name).with_suffix(
            ".log").read_text()
    assert max(_build.build_seconds.values()) < 1.9  # not 3 s in a row
    _build.build(names)  # nothing left to build
    assert len(list((tmp_path / "build").glob("*.so"))) == 3


def test_failed_build_raises_with_its_log(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad code'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_seconds", {})
    with pytest.raises(RuntimeError, match="nvcc failed for cone_proj.cu"
                       "(.|\n)*bad code"):
        _build.build(["cone_proj"])
    assert not list((tmp_path / "build").glob("*.so"))
