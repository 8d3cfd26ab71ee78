"""The PSD and custom cones of the port against the JAX package.

Every input is made with numpy from a fixed seed and handed to both
``totsu_tpu`` and ``totsu_tpu_torch``. The PSD projections (``'eigh'``,
``'ns'``, ``'jacobi'``) compute the same arithmetic in both packages, so
they agree to roundoff: within 1e-12 in f64, within 1e-5 of ||X||_F in
f32 (the eigensolvers and matmul sums differ in order). JAX's Jacobi runs
only at k <= 16, where its unrolled rounds compile in seconds.

Kernel J (``csrc/psd_jacobi.cu``) cannot run here; its launch plan and
its block table are pure functions checked below, and a numpy model of
its arithmetic (A by position in each CTA's block slots, two buffers, the
pivot array's two slots in every CTA, the players of a round without a
division, each CTA's rows of V, for clusters of 1 to 8 CTAs) is held
against the plain version. A CUDA tensor reaches the kernel or raises: a
stubbed build failure shows it.
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
# kernel J: its plan, its block table, a model of its arithmetic, and its
# no-fallback rule

H100_SMEM = 232_448  # bytes a block may opt in to on an H100
H100_SMS = 132
F32, F64 = torch.float32, torch.float64


# (k, count, dtype) -> (cluster, A and V in shared memory, A split over
# the cluster, slots held in registers, threads): phase 23's shapes of
# chip_smoke.py and the shapes on either side of each switch of the
# plan's layout
PLAN_CASES = {
    (8, 1, F32): (1, True, False, True, 32),
    (8, 1, F64): (1, True, False, True, 32),
    (8, 16, F32): (1, True, False, True, 32),
    (8, 512, F64): (1, True, False, True, 32),
    (16, 64, F32): (1, True, False, True, 32),
    (16, 64, F64): (1, True, False, True, 32),
    (16, 1, F32): (1, True, False, True, 32),
    (17, 1, F32): (4, True, False, True, 32),
    (48, 1, F32): (4, True, False, True, 160),
    (48, 1, F64): (4, True, False, True, 160),
    (64, 1, F32): (4, True, False, True, 288),
    (65, 1, F32): (8, True, False, True, 288),
    (128, 1, F32): (8, True, False, True, 512),
    (128, 1, F64): (8, True, False, True, 512),
    (128, 8, F32): (8, True, False, True, 512),
    (128, 9, F32): (4, True, False, True, 512),
    (128, 16, F32): (4, True, False, True, 512),
    (128, 132, F32): (1, True, False, True, 512),
    (128, 132, F64): (2, True, False, True, 512),
    (148, 1, F64): (8, True, False, True, 512),
    (149, 1, F64): (16, True, False, True, 512),
    (152, 1, F64): (16, True, False, True, 512),
    (153, 1, F64): (8, True, True, True, 416),
    (160, 1, F32): (8, True, False, False, 512),
    (192, 1, F32): (8, True, False, False, 512),
    (193, 1, F32): (16, True, False, False, 512),
    (193, 1, F64): (16, True, True, True, 352),
    (256, 1, F32): (16, True, True, True, 288),
    (256, 1, F64): (16, True, True, True, 512),
    (256, 132, F64): (8, True, True, True, 512),
    (155, 132, F64): (2, True, True, True, 512),
    (409, 1, F32): (16, True, True, True, 512),
    (409, 1, F64): (1, False, False, False, 512),
    (511, 1, F32): (16, True, True, False, 512),
    (587, 1, F32): (1, False, False, False, 512),
}


@pytest.mark.parametrize("k,count,dtype", sorted(PLAN_CASES, key=str))
def test_plan(k, count, dtype):
    cluster, smem, split, held, threads = PLAN_CASES[(k, count, dtype)]
    pl = pj.plan(k, count, dtype, H100_SMEM, H100_SMS)
    elem = 4 if dtype == F32 else 8
    kp = k + k % 2
    h = kp // 2
    assert (pl.cluster, pl.smem_layout, pl.split, pl.held, pl.threads) == (
        cluster, smem, split, held, threads)
    assert pl.k == k and pl.kp == kp and pl.count == count
    assert pl.warps == threads // 32 and threads % 32 == 0
    assert threads <= pj.MAX_THREADS
    # V's rows split over the cluster in 16-byte groups; A's block slots
    # of the (P, Q) triangle in equal shares, or all of them in each CTA
    assert pl.rows == -(-(-(-kp // cluster)) // (16 // elem)) * (16 // elem)
    assert pl.rows * cluster >= kp
    nblk = h * (h + 1) // 2
    assert pl.slots == (-(-nblk // cluster) if split else nblk)
    # a warp's run of slots, a lane's slots in registers
    assert pl.warp_slots == -(-pl.slots // pl.warps)
    assert pl.held == (smem and pl.warp_slots
                       <= 32 * pj.SLOTS_PER_THREAD[split])
    # shared memory per CTA: A's two buffers (or the rebuild's staging), V,
    # two slots of the pivot array with a sink (or each pair's diagonal
    # slot), each warp's c and s and list of the pairs it needs
    w = 16 // elem

    def up(x):
        return -(-x // w) * w
    region = up(max(8 * pl.slots, kp * pl.rows))
    piv = up(2 * (kp + h + 1))
    rot = pl.warps * (up(kp) + -(-4 * h // 16) * 16 // elem)
    if smem:
        assert pl.smem_bytes == elem * (region + kp * pl.rows + piv + rot)
        assert pl.scratch_elems == 0
    else:
        assert cluster == 1 and not split and pl.rows == up(kp)
        assert pl.smem_bytes == elem * piv
        assert pl.scratch_elems == region + kp * pl.rows + rot
    assert pl.smem_bytes <= H100_SMEM
    assert pl.set_attribute == (pl.smem_bytes > 48 * 1024)
    assert pl.nonportable == (cluster > 8)
    text = pl.describe()
    assert text.startswith(f"k={k}: {count} x {cluster} CTA")
    assert f"{threads} threads" in text
    assert ("global scratch" if not smem else "split over the cluster"
            if split else "whole in each CTA") in text
    assert ("read from the table" in text) == (not held)
    assert ("opt-in" in text) == pl.set_attribute
    # a pure function
    assert pj.plan(k, count, dtype, H100_SMEM, H100_SMS) == pl


def _fits(k, count, dtype, cluster, split):
    try:
        pj.plan(k, count, dtype, H100_SMEM, H100_SMS, cluster=cluster,
                split=split)
        return True
    except ValueError:
        return False


def test_plan_cluster_rule():
    # the size the order wants while count x size fits a SM_SHARE-th of
    # the SMs (a cluster sits in one GPC); the whole
    # of A in each CTA where it fits one, at the least cluster that fits
    # at or above that size; else A split over the least cluster that
    # holds its slots in registers (or fits) at or above it
    for dtype in (F32, F64):
        for k in range(1, 420, 7):
            for count in (1, 8, 16, 33, 132, 1000):
                pl = pj.plan(k, count, dtype, H100_SMEM, H100_SMS)
                if not pl.smem_layout:
                    assert not any(_fits(k, count, dtype, c, sp)
                                   for c in pj.CLUSTERS for sp in (0, 1))
                    continue
                kp = k + k % 2
                want = next((c for top, c in pj.CLUSTER_WANT if kp <= top),
                            16)
                size = min(want, max(
                    c for c in pj.CLUSTERS
                    if c == 1 or count * c * pj.SM_SHARE <= H100_SMS))
                whole = [c for c in pj.CLUSTERS
                         if _fits(k, count, dtype, c, False)]
                if whole:
                    assert not pl.split and pl.cluster == min(
                        [c for c in whole if c >= size] or [max(whole)])
                    continue
                parts = [c for c in pj.CLUSTERS[1:]
                         if _fits(k, count, dtype, c, True)]
                held = [c for c in parts if pj.plan(
                    k, count, dtype, H100_SMEM, H100_SMS, cluster=c,
                    split=True).held]
                least = min(held or parts)
                assert pl.split and pl.cluster == min(
                    c for c in parts if c >= max(least, size))


def test_plan_refuses():
    with pytest.raises(ValueError, match="dtype"):
        pj.plan(8, 1, torch.bfloat16, H100_SMEM)
    with pytest.raises(ValueError, match="k 0"):
        pj.plan(0, 1, torch.float32, H100_SMEM)
    with pytest.raises(ValueError, match="k 4097"):
        pj.plan(4097, 1, torch.float32, H100_SMEM)
    with pytest.raises(ValueError, match="cluster 3"):
        pj.plan(8, 1, torch.float32, H100_SMEM, cluster=3)
    with pytest.raises(ValueError, match="threads 48"):
        pj.plan(8, 1, torch.float32, H100_SMEM, threads=48)
    with pytest.raises(ValueError, match="does not fit a cluster of 1"):
        pj.plan(256, 1, torch.float32, H100_SMEM, cluster=1)
    with pytest.raises(ValueError, match="does not fit a cluster of 2"):
        pj.plan(256, 1, torch.float32, H100_SMEM, cluster=2, split=False)
    with pytest.raises(ValueError, match="shared"):
        pj.plan(256, 1, torch.float32, 1024)  # not even the pivot array


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


def _lim(x, r, kp):
    """``psd_jacobi.cu``: the low position X of a pair holds its smaller
    row in round r."""
    n = kp - 1
    return (x == 0) | (r < x) | (r >= n - x)


@pytest.mark.parametrize("kp", [2, 4, 8, 16, 50, 256])
def test_kernel_pairs_are_the_schedule(kp):
    # the kernel's players, by position and round without a division, are
    # the schedule's; each position's player moves to _next_pos in the
    # next round; and the low position holds the smaller row where _lim
    # says so
    sched = tjac._schedule(kp)
    pos = np.arange(kp)
    x = np.arange(kp // 2)
    for rd in range(kp - 1):
        players = pj.player(pos, rd, kp)
        part = [None] * kp
        for p in range(kp // 2):
            a, b = players[p], players[kp - 1 - p]
            part[a], part[b] = b, a
        assert tuple(part) == sched[rd]
        nxt = pj.player(pj._next_pos(pos, kp), (rd + 1) % (kp - 1), kp)
        assert (nxt == players).all()
        np.testing.assert_array_equal(
            _lim(x, rd, kp), players[x] < players[kp - 1 - x])
    # after a sweep the positions are the rows again
    assert (pj.player(pos, 0, kp) == pos).all()


def _decode(tab):
    """The table's fields: (P, Q, valid), destinations (rank, offset) of
    the four values, their pivot-array indices."""
    t = tab.view(np.uint32).astype(np.int64)
    valid = t[..., 0] != 0xFFFFFFFF
    p, q = t[..., 0] & 0xFFFF, t[..., 0] >> 16
    codes = t[..., 1:5]
    piv = np.stack([t[..., 5] & 0xFFFF, t[..., 5] >> 16,
                    t[..., 6] & 0xFFFF, t[..., 6] >> 16], axis=-1)
    return p, q, valid, codes >> 24, codes & 0xFFFFFF, piv


@pytest.mark.parametrize("kp,cluster", [(2, 1), (4, 2), (8, 1), (8, 4),
                                        (16, 16), (50, 1), (50, 8),
                                        (128, 8), (256, 16)])
def test_block_table(kp, cluster):
    h = kp // 2
    tab = pj.block_table(kp, cluster)
    nblk = h * (h + 1) // 2
    slots = -(-nblk // cluster)
    assert tab.shape == (cluster, slots, pj.DESC) and tab.dtype == np.int32
    p, q, valid, rank, off, piv = _decode(tab)
    # every block (P <= Q) once, in compact tiles: CTA c owns slots
    # 0 .. n_c - 1 (value e of slot s at e * slots + s), empty slots are
    # all ones
    assert valid.sum() == nblk
    assert sorted(zip(p[valid], q[valid])) == [
        (a, b) for a in range(h) for b in range(a, h)]
    for c in range(cluster):
        n_c = valid[c].sum()
        assert valid[c, :n_c].all() and not valid[c, n_c:].any()
        assert (tab[c, n_c:] == -1).all()
    # the destinations are a permutation of the CTAs' value places
    # (each value moves to its next positions' block; the diagonal block's
    # unused mirror to its own place)
    seen = np.zeros((cluster, 4, slots), np.int64)
    np.add.at(seen, (rank[valid], off[valid] // slots, off[valid] % slots),
              1)
    for c in range(cluster):
        n_c = valid[c].sum()
        assert (seen[c, :, :n_c] == 1).all() and not seen[c, :, n_c:].any()
    # a value's destination holds the same matrix entry in the next round
    hi = kp - 1
    place = {}
    for c in range(cluster):
        for s in np.nonzero(valid[c])[0]:
            a, b = p[c, s], q[c, s]
            for e, (u, v) in enumerate(((a, b), (a, hi - b), (hi - a, b),
                                        (hi - a, hi - b))):
                place[(c, e * slots + s)] = (u, v)
    for rd in range(min(kp - 1, 6)):
        for c in range(cluster):
            for s in np.nonzero(valid[c])[0]:
                for e in range(4):
                    if p[c, s] == q[c, s] and e == 2:
                        continue
                    u, v = place[(c, e * slots + s)]
                    du, dv = place[(rank[c, s, e], off[c, s, e])]
                    nu, nv = pj._next_pos(np.array([u, v]), kp)
                    assert {int(nu), int(nv)} == {int(du), int(dv)}
                    assert pj.player(du, (rd + 1) % hi, kp) in (
                        pj.player(u, rd, kp), pj.player(v, rd, kp))


@pytest.mark.parametrize("kp,cluster", [(2, 1), (8, 1), (8, 4), (50, 2),
                                        (256, 16)])
def test_block_table_pivots(kp, cluster):
    # each value that is the next round's diagonal (index = its next
    # position) or pivot (kp + the pair) says so, exactly once each; the
    # others go to the sink kp + kp/2
    h = kp // 2
    p, q, valid, _, _, piv = _decode(pj.block_table(kp, cluster))
    hi = kp - 1
    got = {}
    for c in range(cluster):
        for s in np.nonzero(valid[c])[0]:
            a, b = p[c, s], q[c, s]
            for e, (u, v) in enumerate(((a, b), (a, hi - b), (hi - a, b),
                                        (hi - a, hi - b))):
                if a == b and e == 2:
                    assert piv[c, s, e] == kp + h
                    continue
                nu, nv = (int(x) for x in pj._next_pos(np.array([u, v]), kp))
                want = (nu if nu == nv else kp + min(nu, nv)
                        if nu + nv == hi else kp + h)
                assert piv[c, s, e] == want
                if want != kp + h:
                    assert want not in got
                    got[want] = (nu, nv)
    assert sorted(got) == list(range(kp + h))


@pytest.mark.parametrize("kp,cluster,threads", [(256, 16, 288),
                                                (128, 8, 512), (50, 4, 64),
                                                (12, 8, 32)])
def test_block_order_spreads_the_pivots(kp, cluster, threads):
    # split over a cluster, every CTA makes an equal share of the next
    # round's pivots and diagonals (each goes to every CTA), spread over
    # its warps' runs of slots; every block once
    h = kp // 2
    p, q = pj.block_order(h, cluster, threads)
    assert sorted(zip(p.tolist(), q.tolist())) == [
        (a, b) for a in range(h) for b in range(a, h)]
    tab = pj.block_table(kp, cluster, threads)
    _, _, valid, _, _, piv = _decode(tab)
    made = ((piv != kp + h) & valid[..., None]).sum(axis=-1)  # per slot
    per_cta = made.sum(axis=1)
    assert per_cta.sum() == kp + h
    slots = tab.shape[1]
    full = min(cluster, -(-(h * (h + 1) // 2) // slots))
    assert per_cta.max() - per_cta[:full].min() <= 4
    warps = threads // 32
    warp = np.arange(slots) // -(-slots // warps)  # the warps' runs
    for c in range(cluster):
        by_warp = np.bincount(warp, weights=made[c] > 0)
        assert by_warp.max() <= -(-(made[c] > 0).sum() // warps) + 1


def _kernel_model_block(vn, scaled, sweeps, cluster, split):
    """numpy model of one cluster of kernel J on one packed block ``vn``,
    with the wrapper's block table: A by position in block slots, two
    buffers, split over the CTAs (``split``) or whole in each (one copy
    here: every CTA computes it alike). With ``split``, the pivot array's
    two slots, one copy per CTA, each warp's rotations computed from its
    own copy (they must agree bitwise), and each value that is flagged
    sent to every CTA's copy; else each pair's pivot and diagonals read
    from its diagonal block's slot. Each slot's values rotated and sent to
    their destinations (each place written once a round); each CTA's rows
    of V updated with the players of the round; the rebuild from every
    CTA's rows scaled by sqrt(max(w, 0)). The kernel's order of
    operations, each loop over threads one vector operation (its MUFU
    divisions and roots exact here)."""
    dt = vn.dtype.type
    elem = vn.dtype.itemsize
    sn = vn.shape[0]
    k = tsym.order_from_len(sn)
    kp = k + k % 2
    h, n = kp // 2, kp - 1
    ctas = cluster if split else 1  # the copies of A's slots
    tab = pj.block_table(kp, ctas)
    p, q, valid, rank, off, pidx = _decode(tab)
    slots = tab.shape[1]
    dslot = {int(p[0, s]): s for s in np.nonzero(valid[0] & (p[0] == q[0]))[0]}
    rows = pj.rows_per_cta(kp, cluster, elem)
    rr, cc = tsym._pack_index(k)
    scale = (rr != cc) & bool(scaled)
    a0 = np.zeros((kp, kp), vn.dtype)
    val = np.where(scale, vn * dt(1 / math.sqrt(2)), vn)
    a0[rr, cc] = val
    a0[cc, rr] = val
    pa = np.zeros((2, ctas, 4 * slots), vn.dtype)
    for c in range(ctas):
        s = np.nonzero(valid[c])[0]
        a, b = p[c, s], q[c, s]
        for e, (u, v) in enumerate(((a, b), (a, n - b), (n - a, b),
                                    (n - a, n - b))):
            pa[0, c, e * slots + s] = np.where((a == b) & (e == 2), 0,
                                               a0[u, v])
    piv = np.zeros((2, cluster, kp + h + 1), vn.dtype)
    piv[0, :, :kp] = np.diag(a0)
    piv[0, :, kp:kp + h] = a0[np.arange(h), n - np.arange(h)]
    vt = np.zeros((cluster, kp, rows), vn.dtype)
    for c in range(cluster):
        for i in range(rows):
            if c * rows + i < kp:
                vt[c, c * rows + i, i] = 1
    x = np.arange(h)
    par = 0
    for _ in range(sweeps):
        for rd in range(n):
            nxt = 1 - par
            rots = []
            for c in range(cluster):
                pc = piv[par, c]
                lim = _lim(x, rd, kp)
                if split:
                    dl, dh, a = pc[x], pc[n - x], pc[kp + x]
                else:  # the diagonal blocks' slots
                    at = np.array([dslot[i] for i in x], np.int64)
                    dl, a, dh = (pa[par, 0, e * slots + at] for e in (0, 1, 3))
                aii, ajj = np.where(lim, dl, dh), np.where(lim, dh, dl)
                theta = (ajj - aii) / (dt(2) * np.where(a != 0, a, dt(1)))
                u = np.abs(theta)
                t = dt(1) / (u + np.sqrt(np.minimum(u * u + dt(1),
                                                    dt(1e36))))
                t = np.where(theta < 0, -t, t)
                cr = dt(1) / np.sqrt(t * t + dt(1))
                s = np.where(a != 0, t * cr, dt(0))
                rots.append((np.where(a != 0, cr, dt(1)),
                             np.where(lim, s, -s)))
            for r2 in rots[1:]:
                assert all((x1 == x2).all() for x1, x2 in zip(rots[0], r2))
            rc, rs = rots[0]
            written = np.zeros((ctas, 4 * slots), np.int64)
            for c in range(ctas):
                s = np.nonzero(valid[c])[0]
                pp, qq = p[c, s], q[c, s]
                x11, x12, x21, x22 = (pa[par, c, e * slots + s]
                                      for e in range(4))
                x21 = np.where(pp == qq, x12, x21)
                cp, sp, cq, sq = rc[pp], rs[pp], rc[qq], rs[qq]
                b11, b12 = x11 * cq - x12 * sq, x12 * cq + x11 * sq
                b21, b22 = x21 * cq - x22 * sq, x22 * cq + x21 * sq
                ys = (b11 * cp - b21 * sp, b12 * cp - b22 * sp,
                      b21 * cp + b11 * sp, b22 * cp + b12 * sp)
                for e in range(4):
                    pa[nxt, rank[c, s, e], off[c, s, e]] = ys[e]
                    np.add.at(written, (rank[c, s, e], off[c, s, e]), 1)
                    if split:
                        piv[nxt][:, pidx[c, s, e]] = ys[e]
            for c in range(ctas):
                n_c = valid[c].sum()
                assert all((written[c, e * slots:e * slots + n_c] == 1).all()
                           for e in range(4))
            b1, b2 = pj.player(x, rd, kp), pj.player(n - x, rd, kp)
            for c in range(cluster):
                v1, v2 = vt[c, b1].copy(), vt[c, b2].copy()
                vt[c, b1] = v1 * rc[:, None] - v2 * rs[:, None]
                vt[c, b2] = v2 * rc[:, None] + v1 * rs[:, None]
            par = nxt
    if split:
        w = piv[par, 0, :kp]
    else:
        w = np.array([pa[par, 0, dslot[b]] if b < h else
                      pa[par, 0, 3 * slots + dslot[n - b]]
                      for b in range(kp)])
    ut = np.concatenate(list(vt), axis=1) * np.sqrt(np.maximum(w, 0))[:, None]
    xp = np.einsum("br,bc->rc", ut, ut)[:k, :k]
    return np.where(scale, xp[rr, cc] * dt(math.sqrt(2)), xp[rr, cc])


def _kernel_model(v, scaled, sweeps, cluster, split):
    """:func:`_kernel_model_block` for every row of ``v`` (count, sn)."""
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        return np.stack([_kernel_model_block(vn, scaled, sweeps, cluster,
                                             split) for vn in v])


@pytest.mark.parametrize("cluster,split", [(1, False), (2, False),
                                           (4, False), (2, True), (4, True),
                                           (8, True)])
@pytest.mark.parametrize("k", [1, 2, 5, 8, 11])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_model_matches_plain(k, dtype, cluster, split):
    v = _packed(k, 3, 40 + k).astype(dtype)
    v[1, :] = 0.0                       # all pivots zero: the identity
    v[2, tsym.tri_len(k) - 1] = 0.0     # a zero pivot among others
    sweeps = tjac.sweeps_for(k)
    scale = np.linalg.norm(v, axis=1).max()
    tol = 1e-13 if dtype == np.float64 else 2e-6
    for scaled in (True, False):
        got = _kernel_model(v, scaled, sweeps, cluster, split)
        want = pj.proj_psd_jacobi_plain(torch.from_numpy(v), scaled).numpy()
        assert np.abs(got - want).max() <= tol * scale


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
