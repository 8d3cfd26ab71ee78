"""The PSD and custom cones of the port against the JAX package.

Every input is made with numpy from a fixed seed and handed to both
``totsu_tpu`` and ``totsu_tpu_torch``. The PSD projections (``'eigh'``,
``'ns'``, ``'jacobi'``) compute the same arithmetic in both packages, so
they agree to roundoff: within 1e-12 in f64, within 1e-5 of ||X||_F in
f32 (the eigensolvers and matmul sums differ in order). JAX's Jacobi runs
only at k <= 16, where its unrolled rounds compile in seconds.

Kernel J (``csrc/psd_jacobi.cu``) cannot run here; its launch plan is a
pure function checked below, and a numpy model of its arithmetic (packed
A, the round-robin pairs computed from the round number, each 2 x 2 block
of pairs rotated once) is held against the plain version. A CUDA
tensor reaches the kernel or raises: a stubbed build failure shows it.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.ops import jacobi as jjac
from totsu_tpu.ops import sympack as jsym
from totsu_tpu.solver import cone as jcone
from totsu_tpu_torch.ops import jacobi as tjac
from totsu_tpu_torch.ops import sympack as tsym
from totsu_tpu_torch.ops.kernels import _build
from totsu_tpu_torch.ops.kernels import psd_jacobi as pj
from totsu_tpu_torch.solver import cone as tcone


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the matrices are small, and the suite runs
    several workers on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _packed(k, count, seed):
    return np.random.default_rng(seed).normal(size=(count,
                                                    k * (k + 1) // 2))


def test_ns_schedule_equals_jax():
    got = tsym._ns_scaled_schedule()
    assert got == jsym._ns_scaled_schedule()
    assert len(got) == 17


CASES = ([(m, k, c) for m in ("eigh", "ns", "jacobi") for k in (2, 5, 8, 16)
          for c in (1, 64)]
         + [(m, 48, c) for m in ("eigh", "ns") for c in (1, 64)])


@pytest.mark.parametrize("method,k,count", CASES)
def test_proj_psd_packed_matches_jax(method, k, count):
    v = _packed(k, count, 100 * k + count)
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32,
                                                   jnp.float32)):
        want = np.asarray(jsym.proj_psd_packed(jnp.asarray(v, jdt),
                                               method=method), np.float64)
        got = tsym.proj_psd_packed(torch.as_tensor(v, dtype=dt),
                                   method=method)
        assert got.dtype == dt and got.shape == v.shape
        err = np.abs(got.double().numpy() - want).max()
        if dt == torch.float64:
            assert err <= 1e-12, err
        else:
            assert err <= 1e-5 * np.linalg.norm(v, axis=1).max(), err


def test_proj_psd_packed_unknown_method():
    with pytest.raises(ValueError, match="unknown PSD projection method"):
        tsym.proj_psd_packed(torch.zeros(3, dtype=torch.float64),
                             method="svd")


def test_psd_part_ns_unscaled_iters_matches_jax():
    x = np.random.default_rng(7).normal(size=(4, 6, 6))
    x = x + x.transpose(0, 2, 1)
    want = np.asarray(jsym.psd_part_ns(jnp.asarray(x), iters=30))
    got = tsym.psd_part_ns(torch.from_numpy(x), iters=30).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("k", [3, 6, 8, 16])
def test_jacobi_eigh_matches_jax_in_its_order(k):
    x = np.random.default_rng(k).normal(size=(3, k, k))
    x = x + x.transpose(0, 2, 1)
    wj, vj = jjac.jacobi_eigh(jnp.asarray(x))
    wt, vt = tjac.jacobi_eigh(torch.from_numpy(x))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=1e-12)


def test_jacobi_schedule_equals_jax():
    for kp in (2, 4, 8, 16, 50):
        assert tjac._schedule(kp) == jjac._schedule(kp)


def test_jacobi_sweep_rule():
    assert [tjac.sweeps_for(k) for k in (2, 128, 129, 256)] == [10, 10, 14,
                                                               14]
    assert tjac.sweeps_for(300, 5) == 5
    with pytest.raises(ValueError, match="unmeasured"):
        tjac.sweeps_for(257)
    with pytest.raises(ValueError, match="unmeasured"):
        tjac.psd_part_jacobi(torch.zeros(1, 257, 257))


# ---------------------------------------------------------------------------
# the ported tests/test_cones.py cases (custom cones, Jacobi), each run in
# both packages


def _project(layout, x, dual, torch_side):
    if torch_side:
        return layout.project(torch.from_numpy(np.asarray(x, np.float64)),
                              dual).numpy()
    return np.asarray(layout.project(jnp.asarray(x, jnp.float64), dual))


@pytest.mark.parametrize("dual", [False, True])
def test_custom_matches_builtin_rpos(dual):
    x = np.random.default_rng(3).normal(size=5)
    want = _project(jcone.ConeLayout([jcone.rpos(5)]), x, dual, False)
    for cone_mod, fn, side in (
            (jcone, lambda b: jnp.maximum(b, 0.0), False),
            (tcone, lambda b: torch.clamp(b, min=0.0), True)):
        lay = cone_mod.ConeLayout([cone_mod.custom(5, fn, grouped=False)])
        np.testing.assert_allclose(_project(lay, x, dual, side), want)


def test_custom_moreau_dual_zero_cone():
    x = np.array([1.0, -2.0, 3.0, -4.0])
    for cone_mod, fn, side in ((jcone, jnp.zeros_like, False),
                               (tcone, torch.zeros_like, True)):
        lay = cone_mod.ConeLayout([cone_mod.custom(4, fn)])
        np.testing.assert_allclose(_project(lay, x, False, side),
                                   np.zeros(4))
        np.testing.assert_allclose(_project(lay, x, True, side), x)


def test_custom_blocked_soc_and_grouping():
    rng = np.random.default_rng(4)
    x = rng.normal(size=6)
    t = rng.uniform(1.0, 2.0, size=6)
    jl = jcone.ConeLayout([jcone.custom(3, jcone._proj_soc_blocks, count=2,
                                        dual_proj=jcone._proj_soc_blocks)])
    tl = tcone.ConeLayout([tcone.custom(3, tcone._proj_soc_blocks, count=2,
                                        dual_proj=tcone._proj_soc_blocks)])
    ref = tcone.ConeLayout([tcone.soc(3, count=2)])
    for dual in (False, True):
        want = _project(jl, x, dual, False)
        np.testing.assert_allclose(_project(tl, x, dual, True), want,
                                   atol=1e-12)
        np.testing.assert_allclose(_project(ref, x, dual, True), want,
                                   atol=1e-12)
    np.testing.assert_array_equal(
        tl.group_min(torch.from_numpy(t)).numpy(),
        np.asarray(jl.group_min(jnp.asarray(t))))
    assert tl.factors[0].needs_group
    assert not tcone.custom(3, tcone._proj_soc_blocks,
                            grouped=False).needs_group


def test_custom_proj_gets_the_solve_device_and_dtype():
    seen = []

    def proj(b):
        seen.append((tuple(b.shape), b.dtype, b.device.type))
        return torch.clamp(b, min=0.0)

    lay = tcone.ConeLayout([tcone.custom(2, proj, count=3)])
    x = torch.linspace(-1.0, 1.0, 6, dtype=torch.float32)
    out = lay.project(x, dual=True)  # Moreau: x + proj(-x), R+ again
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.maximum(x.numpy(), 0.0))
    assert seen == [((3, 2), torch.float32, "cpu")]


def test_custom_end_to_end_lp_parity():
    # the golden LP with a custom R+ factor takes the reference's 160
    # updates in both packages
    c = np.array([-1.0, 0.0])
    g = np.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    h = np.array([6.0, 6.0, 1.0])
    rj = jt.solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
                      jt.ConeLayout([jt.custom(3, lambda b: jnp.maximum(
                          b, 0.0), grouped=False)]),
                      jt.SolverParam(max_iter=10_000))
    rt = tt.solve_jit(torch.from_numpy(c), torch.from_numpy(g),
                      torch.from_numpy(h),
                      tt.ConeLayout([tt.custom(3, lambda b: torch.clamp(
                          b, min=0.0), grouped=False)]),
                      tt.SolverParam(max_iter=10_000))
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert rt.iters == int(rj.iters) == 160
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-9)


def test_custom_grouped_cone_survives_equilibration():
    # Ruiz applies block-uniform row scaling to a grouped custom factor as
    # to the builtin soc. The JAX test's instance takes 108,533 iterations
    # to eps_acc 1e-6 (about 97 s eager on the CPU), so both packages run
    # its first 3,000: the custom layout follows the builtin one bit for
    # bit, and the JAX package's custom layout to 1e-8
    rng = np.random.default_rng(30)
    n = 6
    g = rng.normal(size=(3, n)) * np.array([[1e3], [1.0], [1e-3]])
    c = rng.normal(size=n)
    h = np.abs(rng.normal(size=3))
    eye = np.eye(n)
    g_full = np.concatenate([g, eye, -eye], axis=0)
    h_full = np.concatenate([h, np.full(n, 2.0), np.full(n, 2.0)])
    kw = dict(max_iter=3_000, eps_acc=1e-6, equil_iters=10)
    lay_j = jt.ConeLayout([jt.custom(3, jcone._proj_soc_blocks,
                                     dual_proj=jcone._proj_soc_blocks),
                           jt.rpos(2 * n)])
    rj = jt.solve_jit(jnp.asarray(c), jnp.asarray(g_full),
                      jnp.asarray(h_full), lay_j, jt.SolverParam(**kw))
    data = [torch.from_numpy(x) for x in (c, g_full, h_full)]
    rb = tt.solve_jit(*data, tt.ConeLayout([tt.soc(3), tt.rpos(2 * n)]),
                      tt.SolverParam(**kw))
    rc = tt.solve_jit(*data, tt.ConeLayout(
        [tt.custom(3, tcone._proj_soc_blocks,
                   dual_proj=tcone._proj_soc_blocks), tt.rpos(2 * n)]),
        tt.SolverParam(**kw))
    assert rb.status == rc.status == int(rj.status)
    assert rb.iters == rc.iters == int(rj.iters) == 3_000
    assert torch.equal(rc.x, rb.x) and torch.equal(rc.y, rb.y)
    np.testing.assert_allclose(rc.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(rc.y.numpy(), np.asarray(rj.y), rtol=0,
                               atol=1e-8)


def test_psd_jacobi_matches_eigh():
    rng = np.random.default_rng(11)
    for k in (2, 5, 8):
        v = torch.from_numpy(rng.normal(size=(3, tsym.tri_len(k))))
        np.testing.assert_allclose(
            tsym.proj_psd_packed(v, method="jacobi").numpy(),
            tsym.proj_psd_packed(v, method="eigh").numpy(), atol=1e-10)


@pytest.mark.parametrize("dual", [False, True])
def test_psd_jacobi_cone_end_to_end(dual):
    x = np.random.default_rng(12).normal(size=3)
    want = _project(jcone.ConeLayout([jcone.psd(2, method="eigh")]), x,
                    dual, False)
    for method in ("eigh", "jacobi", "auto"):  # 'auto' outside a solve: eigh
        lay = tcone.ConeLayout([tcone.psd(2, method=method)])
        np.testing.assert_allclose(_project(lay, x, dual, True), want,
                                   atol=1e-10)


def test_jacobi_eigh_properties():
    rng = np.random.default_rng(13)
    for k in (3, 20, 33):  # odd sizes exercise the zero-padding path
        x = rng.normal(size=(4, k, k))
        x = (x + x.transpose(0, 2, 1)) / 2
        w, v = tjac.jacobi_eigh(torch.from_numpy(x), sweeps=12)
        w, v = w.numpy(), v.numpy()
        rec = np.einsum("bik,bk,bjk->bij", v, w, v)
        np.testing.assert_allclose(rec, x, atol=1e-12)
        orth = np.einsum("bik,bjk->bij", v, v)
        np.testing.assert_allclose(
            orth, np.broadcast_to(np.eye(k), orth.shape), atol=1e-12)
        np.testing.assert_allclose(np.sort(w, axis=-1),
                                   np.linalg.eigvalsh(x), atol=1e-11)


def test_jacobi_eigh_symmetrizes_input():
    x = np.random.default_rng(21).normal(size=(2, 6, 6))  # asymmetric
    wj, _ = jjac.jacobi_eigh(jnp.asarray(x), sweeps=12)
    wt, _ = tjac.jacobi_eigh(torch.from_numpy(x), sweeps=12)
    xs = (x + x.transpose(0, 2, 1)) / 2
    np.testing.assert_allclose(np.sort(wt.numpy(), axis=-1),
                               np.linalg.eigvalsh(xs), atol=1e-11)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-12)


AUTO_CASES = {
    # reference profile: exact only; big k eigh, many small blocks jacobi
    "reference": (None, dict()),
    # fast profile at a loose tolerance: ns where its floor is safe
    "fast": (None, dict(profile="fast", eps_acc=1e-3)),
    # fast profile at a tight tolerance: stays exact
    "tight": (None, dict(profile="fast", eps_acc=1e-6)),
    # an explicit method is never overridden
    "explicit": ("eigh", dict(profile="fast", eps_acc=1e-3)),
}


@pytest.mark.parametrize("case", sorted(AUTO_CASES))
def test_psd_auto_method_resolution(case):
    method, kw = AUTO_CASES[case]

    def layout(mod):
        if method is not None:
            return mod.ConeLayout([mod.psd(48, method=method)])
        return mod.ConeLayout([mod.psd(48), mod.psd(8, count=128),
                               mod.zero(3)])

    want = jcone.resolve_auto_methods(layout(jcone), jt.SolverParam(**kw))
    got = tcone.resolve_auto_methods(layout(tcone), tt.SolverParam(**kw))
    assert ([f.variant for f in got.factors]
            == [f.variant for f in want.factors])
    assert ([(f.kind, f.dim, f.count) for f in got.factors]
            == [(f.kind, f.dim, f.count) for f in want.factors])


def test_cone_from_reference_keeps_the_psd_method():
    from totsu_tpu_torch import interop
    for method in ("auto", "eigh", "ns", "jacobi"):
        tl = interop.cone_from_reference(
            jcone.ConeLayout([jcone.psd(5, 3, method=method)]))
        assert [(f.kind, f.dim, f.count, f.variant) for f in tl.factors] \
            == [("psd", 15, 3, method)]
    with pytest.raises(NotImplementedError, match="custom"):
        interop.cone_from_reference(
            jcone.ConeLayout([jcone.custom(2, jnp.zeros_like)]))


# ---------------------------------------------------------------------------
# kernel J: its plan, a model of its arithmetic, and its no-fallback rule

H100_SMEM = 232_448  # bytes a block may opt in to on an H100


@pytest.mark.parametrize("k,dtype,where,threads", [
    (8, torch.float32, (True, True), 32),
    (8, torch.float64, (True, True), 32),
    (16, torch.float32, (True, True), 128),
    (48, torch.float32, (True, True), 512),
    (49, torch.float64, (True, True), 512),
    (128, torch.float32, (True, True), 512),
    (128, torch.float64, (True, True), 512),
    (194, torch.float32, (True, True), 512),
    (196, torch.float32, (True, False), 512),
    (256, torch.float32, (True, False), 512),
    (256, torch.float64, (False, False), 512),
])
def test_plan(k, dtype, where, threads):
    pl = pj.plan(k, 16, dtype, H100_SMEM)
    elem = 4 if dtype == torch.float32 else 8
    kp = k + k % 2
    assert (pl.a_smem, pl.v_smem) == where
    assert pl.kp == kp and pl.count == 16 and pl.threads == threads
    assert pl.threads % 32 == 0 and pl.threads <= pj.MAX_THREADS
    assert pl.smem_bytes == pj.smem_bytes(k, *where, elem) <= H100_SMEM
    # the layout the kernel reads: A packed, V^T, c and s, the pairs
    assert pl.smem_bytes == (elem * (kp * (kp + 1) // 2 * where[0]
                                     + kp * kp * where[1] + 2 * kp) + 4 * kp)
    assert pl.scratch_elems == ((not where[0]) * kp * (kp + 1) // 2
                                + (not where[1]) * kp * kp)
    assert pl.set_attribute == (pl.smem_bytes > 48 * 1024)
    assert pl.describe().startswith(f"k={k}: 16 CTAs x {threads} threads")


def test_plan_refuses():
    with pytest.raises(ValueError, match="dtype"):
        pj.plan(8, 1, torch.bfloat16, H100_SMEM)
    with pytest.raises(ValueError, match="k 0"):
        pj.plan(0, 1, torch.float32, H100_SMEM)
    with pytest.raises(ValueError, match="shared"):
        pj.plan(256, 1, torch.float32, 1024)  # not even c, s and pairs


def test_ops_count():
    # per round: 14 per pair, 24 per pair of pairs P < Q and 21 on P == Q,
    # 6 per row and pair; the rebuild: max and sqrt per eigenvalue, the
    # k x k scaling, 2 per term, and unpack and pack
    k, sweeps = 8, 10
    per_round = 14 * 4 + 24 * 6 + 21 * 4 + 6 * 4 * 8
    assert per_round == 476
    assert pj.ops_count(k, 3, sweeps) == 3 * (
        sweeps * 7 * per_round + 2 * 8 + 64 + 2 * 8 * 36 + 2 * 36)
    assert pj.ops_count(7, 1, 1) == 7 * per_round + 2 * 7 + 49 \
        + 2 * 7 * 28 + 2 * 28


def _c_mod(a, n):
    """C's ``%`` on ints (truncating)."""
    return int(math.fmod(a, n))


def _player(pos, rd, kp):
    """``psd_jacobi.cu`` ``player``, with C's integer semantics."""
    if pos == 0:
        return 0
    n = kp - 1
    return 1 + _c_mod(_c_mod(pos - 1 - rd, n) + n, n)


def _unpack_index(p):
    """``psd_jacobi.cu`` ``unpack_index``: (row, column) of packed p."""
    q = int((np.sqrt(np.float32(8 * p + 1), dtype=np.float32) - 1) * 0.5)
    while q * (q + 1) // 2 > p:
        q -= 1
    while (q + 1) * (q + 2) // 2 <= p:
        q += 1
    return p - q * (q + 1) // 2, q


@pytest.mark.parametrize("kp", [2, 4, 8, 16, 50, 256])
def test_kernel_pairs_are_the_schedule(kp):
    sched = tjac._schedule(kp)
    for rd in range(kp - 1):
        part = [None] * kp
        for p in range(kp // 2):
            a, b = _player(p, rd, kp), _player(kp - 1 - p, rd, kp)
            part[a], part[b] = b, a
        assert tuple(part) == sched[rd]


def test_kernel_unpack_index():
    got = [_unpack_index(p) for p in range(tsym.tri_len(300))]
    rr, cc = tsym._pack_index(300)
    assert got == list(zip(rr.tolist(), cc.tolist()))


def _pidx(i, j):
    """``psd_jacobi.cu`` ``pidx``: packed index of (i, j), either order."""
    return np.where(i <= j, j * (j + 1) // 2 + i, i * (i + 1) // 2 + j)


def _rotate_block(x11, x12, x21, x22, cs, ss, r1, r2, k1, k2):
    """``psd_jacobi.cu`` ``rotate_block`` on rows (r1, r2), columns
    (k1, k2)."""
    b11 = x11 * cs[k1] - x12 * ss[k1]
    b12 = x12 * cs[k2] - x11 * ss[k2]
    b21 = x21 * cs[k1] - x22 * ss[k1]
    b22 = x22 * cs[k2] - x21 * ss[k2]
    return (b11 * cs[r1] - b21 * ss[r1], b12 * cs[r1] - b22 * ss[r1],
            b21 * cs[r2] - b11 * ss[r2], b22 * cs[r2] - b12 * ss[r2])


def _kernel_model_cta(vn, scaled, sweeps):
    """numpy model of one CTA of kernel J on one packed block ``vn``: A as
    its packed upper triangle, V^T, the pairs from ``_player``, c and s
    once per pair, each 2 x 2 block of pairs (P <= Q) rotated once (on
    P == Q the pivot from y12), the column update, the rebuild from V
    scaled by sqrt(max(w, 0)); the kernel's order of operations, each
    loop over threads one vector operation."""
    dt = vn.dtype.type
    sn = vn.shape[0]
    k = tsym.order_from_len(sn)
    kp = k + k % 2
    h = kp // 2
    rr, cc = tsym._pack_index(k)
    off = (rr != cc) & bool(scaled)
    bp, bq = np.array([_unpack_index(q)
                       for q in range(tsym.tri_len(h))]).T
    a = np.zeros(tsym.tri_len(kp), vn.dtype)
    a[:sn] = np.where(off, vn * dt(1 / math.sqrt(2)), vn)
    vt = np.eye(kp, dtype=vn.dtype)
    for _ in range(sweeps):
        for rd in range(kp - 1):
            pa = np.array([_player(p, rd, kp) for p in range(h)])
            pb = np.array([_player(kp - 1 - p, rd, kp) for p in range(h)])
            i, j = np.minimum(pa, pb), np.maximum(pa, pb)
            aij = a[_pidx(i, j)]
            nz = aij != 0
            theta = (a[_pidx(j, j)] - a[_pidx(i, i)]) / (
                dt(2) * np.where(nz, aij, dt(1)))
            t = np.where(theta == 0, dt(1), np.sign(theta) / (
                np.abs(theta) + np.sqrt(theta * theta + dt(1))))
            c = np.where(nz, dt(1) / np.sqrt(t * t + dt(1)), dt(1))
            s = np.where(nz, t * c, dt(0))
            cs = np.empty(kp, vn.dtype)
            ss = np.empty(kp, vn.dtype)
            cs[i], cs[j], ss[i], ss[j] = c, c, s, -s
            r1, r2, k1, k2 = i[bp], j[bp], i[bq], j[bq]
            idx = [_pidx(r1, k1), _pidx(r1, k2), _pidx(r2, k1),
                   _pidx(r2, k2)]
            x11, x12, x21, x22 = (a[ix] for ix in idx)
            y = _rotate_block(x11, x12, x21, x22, cs, ss, r1, r2, k1, k2)
            off_blk = bp != bq
            a[idx[0]] = y[0]
            a[idx[2][off_blk]] = y[2][off_blk]
            a[idx[1]] = y[1]
            a[idx[3]] = y[3]
            v1, v2 = vt[i].copy(), vt[j].copy()
            vt[i] = v1 * cs[i][:, None] - v2 * ss[i][:, None]
            vt[j] = v2 * cs[j][:, None] - v1 * ss[j][:, None]
    u = vt[:k, :k] * np.sqrt(np.maximum(
        a[_pidx(np.arange(k), np.arange(k))], 0))[:, None]
    x = np.einsum("jr,jc->rc", u, u)
    return np.where(off, x[rr, cc] * dt(math.sqrt(2)), x[rr, cc])


def _kernel_model(v, scaled, sweeps):
    """:func:`_kernel_model_cta` for every row of ``v`` (count, sn). At a
    pivot that has converged to ~1e-170 theta^2 overflows and t = 0, as
    on the card."""
    with np.errstate(over="ignore"):
        return np.stack([_kernel_model_cta(vn, scaled, sweeps)
                         for vn in v])


@pytest.mark.parametrize("k", [1, 2, 5, 8, 11])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_model_matches_plain(k, dtype):
    v = _packed(k, 3, 40 + k).astype(dtype)
    v[1, :] = 0.0                       # all pivots zero: the identity
    v[2, tsym.tri_len(k) - 1] = 0.0     # a zero pivot among others
    sweeps = tjac.sweeps_for(k)
    got = _kernel_model(v, True, sweeps)
    want = pj.proj_psd_jacobi_plain(torch.from_numpy(v), True).numpy()
    scale = np.linalg.norm(v, axis=1).max()
    tol = 1e-13 if dtype == np.float64 else 2e-6
    assert np.abs(got - want).max() <= tol * scale
    got_u = _kernel_model(v, False, sweeps)
    want_u = pj.proj_psd_jacobi_plain(torch.from_numpy(v), False).numpy()
    assert np.abs(got_u - want_u).max() <= tol * scale


def test_cpu_path_is_the_plain_version(monkeypatch):
    v = torch.from_numpy(_packed(6, 4, 5))
    before = pj.launches
    want = pj.proj_psd_jacobi_plain(v)
    np.testing.assert_array_equal(pj.proj_psd_jacobi(v).numpy(),
                                  want.numpy())
    # batched leading dims pass through
    np.testing.assert_array_equal(
        pj.proj_psd_jacobi(v.reshape(2, 2, -1)).numpy(),
        want.reshape(2, 2, -1).numpy())
    assert pj.launches == before
    # the cone layout goes through the wrapper
    calls = []
    monkeypatch.setattr(pj, "proj_psd_jacobi",
                        lambda b, scaled=True: calls.append(b.shape) or b)
    tcone.ConeLayout([tcone.psd(6, 4, method="jacobi")]).project(
        v.reshape(-1), dual=True)
    assert calls == [(4, 21)]


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it reaches the CUDA branch
    of a wrapper on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_launches_or_raises(monkeypatch):
    # a failed build on a CUDA tensor raises: no fallback to the plain
    # version, no launch counted
    def failed_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu: stubbed")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "load", failed_build)
    monkeypatch.setattr(pj, "proj_psd_jacobi_plain", plain)
    monkeypatch.setattr(tjac, "psd_part_jacobi", plain)
    before = pj.launches
    v = torch.Tensor._make_subclass(_OnCard, torch.from_numpy(
        _packed(5, 3, 1)))
    assert v.device.type == "cuda"
    with pytest.raises(RuntimeError, match="nvcc failed for psd_jacobi.cu"):
        pj.proj_psd_jacobi(v)
    with pytest.raises(RuntimeError, match="nvcc failed for psd_jacobi.cu"):
        tsym.proj_psd_packed(v, method="jacobi")
    lay = tcone.ConeLayout([tcone.psd(5, 3, method="jacobi")])
    with pytest.raises(RuntimeError, match="nvcc failed for psd_jacobi.cu"):
        lay.project(v.reshape(-1), dual=False)
    assert pj.launches == before


def test_wrapper_checks_inputs():
    with pytest.raises(ValueError, match="unsupported device"):
        pj.proj_psd_jacobi(torch.zeros(2, 3, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        pj.proj_psd_jacobi_cuda(torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(TypeError, match="f32 or f64"):
        pj.proj_psd_jacobi_cuda(torch.zeros(2, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="triangular"):
        pj.proj_psd_jacobi_cuda(torch.zeros(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(count, k\(k\+1\)/2\)"):
        pj.proj_psd_jacobi_cuda(torch.zeros(3, dtype=torch.float64))
