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


# ---- the kernel's launch plan (ops/kernels/dual_matvec.py `plan`): the
# kernel cannot run here, so its partition is checked on its own
PLAN_SHAPES = [(1, 1), (1, 1000), (173, 77), (8, 128), (4000, 1000),
               (7040, 3040), (300, 1001), (500, 3042)]
PLAN_DTYPES = [torch.float32, torch.bfloat16, torch.float64]


@pytest.mark.parametrize("sm", [1, 7, 132])
@pytest.mark.parametrize("m,n", PLAN_SHAPES)
def test_plan_covers_every_element_once(m, n, sm):
    for dtype in PLAN_DTYPES:
        for aligned in (True, False):
            pl = dm.plan(m, n, dtype, sm, aligned)
            count = np.zeros((m, n), np.uint8)
            for g in range(pl.row_groups):
                for s in range(pl.col_chunks):
                    r, c = pl.rows(g), pl.cols(s)
                    assert len(r) >= 1 and len(c) >= 1
                    count[r.start:r.stop, c.start:c.stop] += 1
            assert count.min() == count.max() == 1, (dtype, aligned)
            # every row group in exactly one reduction group, in order
            grouped = [g for k in range(pl.groups) for g in pl.group(k)]
            assert grouped == list(range(pl.row_groups))
            # balanced to one row and one load; one wave of CTAs
            sizes = [len(pl.rows(g)) for g in range(pl.row_groups)]
            assert max(sizes) - min(sizes) <= 1
            assert max(sizes) <= dm.MAX_ROWS
            widths = [len(pl.cols(s)) for s in range(pl.col_chunks)]
            assert max(widths) - min(widths) <= pl.vec * pl.col_chunks
            assert pl.grid <= max(sm * dm.CTAS_PER_SM, pl.col_chunks,
                                  -(-m // dm.MAX_ROWS) * pl.col_chunks)


@pytest.mark.parametrize("m,n", PLAN_SHAPES)
def test_plan_vector_width_and_threads(m, n):
    for dtype, width in zip(PLAN_DTYPES, (4, 8, 2)):
        pl = dm.plan(m, n, dtype, 132)
        # 16-byte loads wherever n allows, one element otherwise
        assert pl.vec == (width if n % width == 0 else 1)
        assert dm.plan(m, n, dtype, 132, aligned=False).vec == 1
        assert pl.vec * pl.nvec == n
        assert pl.vec * dtype.itemsize in (16, dtype.itemsize)
        # a thread per load of a chunk, whole warps, within the kernel's cap
        assert pl.chunk_vecs <= pl.threads <= dm.MAX_THREADS
        assert pl.threads % 32 == 0 and pl.threads - pl.chunk_vecs < 32


@pytest.mark.parametrize("sm", [1, 7, 132])
@pytest.mark.parametrize("m,n", PLAN_SHAPES)
def test_plan_scratch_matches_its_indexing(m, n, sm):
    # the largest offset the kernel writes into each part of scratch, and
    # the largest counter it takes a ticket from, are inside the sizes
    for dtype in PLAN_DTYPES:
        pl = dm.plan(m, n, dtype, sm)
        g_last, s_last = pl.row_groups - 1, pl.col_chunks - 1
        if pl.row_groups > 1:
            assert pl.q_part_len == g_last * n + pl.cols(s_last).stop
        else:
            assert pl.q_part_len == 0  # q is written directly
        assert pl.q_grp_len == (pl.groups * n if pl.groups > 1 else 0)
        if pl.col_chunks > 1:
            assert pl.p_part_len == s_last * m + pl.rows(g_last).stop
        else:
            assert pl.p_part_len == 0  # p is written directly
        assert pl.scratch_len == pl.q_part_len + pl.q_grp_len + pl.p_part_len
        # tickets: one per reduction group and one for the last group
        assert pl.counters == (0 if pl.grid == 1 else pl.groups + 1)
        assert pl.groups == -(-pl.row_groups // pl.group_size)


def _emulate(a, u, v, pl):
    """The kernel's partition and summation order in plain PyTorch: each
    CTA's partials, then the reduction groups' sums of q in index order,
    the groups' sums in index order, and p's chunks in index order."""
    m, n = a.shape
    q_part = torch.zeros(pl.row_groups, n, dtype=a.dtype)
    p_part = torch.zeros(pl.col_chunks, m, dtype=a.dtype)
    for g in range(pl.row_groups):
        for s in range(pl.col_chunks):
            r, c = pl.rows(g), pl.cols(s)
            rs, cs = slice(r.start, r.stop), slice(c.start, c.stop)
            p_part[s, rs] = a[rs, cs] @ u[cs]
            q_part[g, cs] = v[rs] @ a[rs, cs]
    q_grp = []
    for k in range(pl.groups):
        rows = iter(pl.group(k))
        acc = q_part[next(rows)].clone()
        for g in rows:
            acc += q_part[g]
        q_grp.append(acc)
    q = q_grp[0].clone()
    for acc in q_grp[1:]:
        q += acc
    p = p_part[0].clone()
    for s in range(1, pl.col_chunks):
        p += p_part[s]
    return p, q


@pytest.mark.parametrize("dtype", PLAN_DTYPES)
@pytest.mark.parametrize("sm", [1, 7, 132])
@pytest.mark.parametrize("m,n", [(1, 1), (1, 1000), (173, 77), (8, 128),
                                 (400, 100), (300, 1001), (500, 3042)])
def test_emulated_partition_equals_plain_f64(m, n, sm, dtype):
    # the partition of each storage type's plan, summed in f64, adds every
    # product once: it equals the plain version to 1e-12 of the largest
    # output
    a, u, v = (torch.from_numpy(x) for x in _data(m, n, 5, np.float64))
    pl = dm.plan(m, n, dtype, sm)
    p, q = _emulate(a, u, v, pl)
    pp, qp = dm.dual_matvec_plain(a, u, v)
    scale = max(float(pp.abs().max()), float(qp.abs().max()))
    assert float((p - pp).abs().max()) <= 1e-12 * scale
    assert float((q - qp).abs().max()) <= 1e-12 * scale


def test_plan_is_pure_and_refuses_empty():
    assert dm.plan(4000, 1000, torch.float32, 132) == dm.plan(
        4000, 1000, torch.float32, 132)
    with pytest.raises(ValueError, match="plan"):
        dm.plan(0, 10, torch.float32, 132)
    # the main path's shapes on an H100 (132 SMs): one CTA per SM
    assert dm.plan(4000, 1000, torch.float32, 132).grid == 132
    assert dm.plan(7040, 3040, torch.float32, 132).grid == 132
