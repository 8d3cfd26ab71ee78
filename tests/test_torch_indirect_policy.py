"""The indirect engine's host policy in the port against the JAX package.

Twins of the indirect and routing cases of ``tests/test_direct.py`` and
``tests/test_solver.py``: structured operators on ``method='direct'``
(matrix-free, blocked-ELL, certificates, f32), ``cg_precond``, the CG
truncation warning, the column-spread probe and the auto-equilibration
policy of ``solve()``, and the fast profile's routing of structured
operators. Each problem is made once with numpy and handed to both
packages; where a JAX test holds a solve against a reference, the port's
twin holds the same, and f64 solves also take the JAX package's
iterations. The sizes are the JAX tests' except where a case says so.
"""

import dataclasses
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.solver import conic as jconic
from totsu_tpu.solver import operator as jop
from totsu_tpu.solver.scaling import scaling_spread as jspread
from totsu_tpu_torch import interop
from totsu_tpu_torch.solver import conic as tconic
from totsu_tpu_torch.solver.scaling import scaling_spread

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its problems are small, and
    the suite runs several workers on one machine, where torch's thread
    pools would oversubscribe the cores (measured: the module ran ten
    times slower beside five busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _cone(n_rows):
    return tt.ConeLayout([tt.rpos(n_rows)])


def _objective(c, r):
    return float(np.asarray(c, np.float64) @ r.x.double().numpy())


def _banded_box_lp(n=96, bw=6, seed=7):
    """tests/test_direct.py's banded rows plus a two-sided box."""
    rng = np.random.default_rng(seed)
    band = np.zeros((n, n))
    for i in range(n):
        lo, hi2 = max(0, i - bw), min(n, i + bw)
        band[i, lo:hi2] = rng.normal(size=hi2 - lo)
    a = np.concatenate([band, np.eye(n), -np.eye(n)])
    h = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 5.0)])
    c = rng.normal(size=n)
    return c, a, h


def _ill_scaled_banded(n=128, span=1e4, seed=13):
    """tests/test_direct.py's banded+box LP whose column scales span
    ``span`` (diag(A^T A) spread ~span^2)."""
    rng = np.random.default_rng(seed)
    bw = 9
    a = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - bw // 2), min(n, i + bw // 2 + 1)
        a[i, lo:hi] = rng.normal(size=hi - lo)
    scales = np.exp(np.log(span) * rng.random(n) - 0.5 * np.log(span))
    a = a * scales[None, :]
    a_full = np.concatenate([a, np.eye(n), -np.eye(n)])
    x0 = rng.normal(size=n) / scales
    box = np.full(n, 10.0) / scales
    h = np.concatenate([a @ x0 + rng.random(n) + 0.1, box, box])
    c = rng.normal(size=n) * scales
    return c, a_full, h


def _dense_direct(c, a, h, **kw):
    return tt.solve_jit(_t(c), _t(a), _t(h), _cone(a.shape[0]),
                        tt.SolverParam(max_iter=100_000, method="direct",
                                       **kw))


def _custom(a):
    return tt.CustomOp(params=_t(a), m=a.shape[0], n=a.shape[1],
                       matvec_fn=lambda p, x: p @ x)


def test_direct_indirect_matrix_free():
    # method='direct' on a matrix-free CustomOp (the adjoint from
    # autograd): the dense direct solve's objective, the JAX package's
    # iterations
    c, a, h = _banded_box_lp(n=48)
    kw = dict(check_period=10, accel="halpern")
    r = tt.solve_jit(_t(c), _custom(a), _t(h), _cone(144),
                     tt.SolverParam(max_iter=100_000, method="direct", **kw))
    assert r.status == tt.SolverStatus.CONVERGED
    r_ref = _dense_direct(c, a, h, **kw)
    obj = _objective(c, r_ref)
    assert abs(_objective(c, r) - obj) <= 1e-3 * (1.0 + abs(obj))
    rj = jt.solve_jit(jnp.asarray(c),
                      jt.CustomOp(params=jnp.asarray(a), m=144, n=48,
                                  matvec_fn=lambda p, x: p @ x),
                      jnp.asarray(h), jt.ConeLayout([jt.rpos(144)]),
                      jt.SolverParam(max_iter=100_000, method="direct",
                                     **kw))
    assert r.iters == int(rj.iters)


@pytest.mark.parametrize("accel", ["", "halpern"])
def test_direct_indirect_blocked_ell_parity(accel):
    # the indirect solve on a BlockedEllOp, and with Ruiz, reach the dense
    # direct solve's objective. The JAX test runs n = 96 at eps_acc 1e-5
    # (about 9,000 DR iterations, half a minute per solve on the port's
    # CPU host loop); here n = 48 at 1e-4
    c, a, h = _banded_box_lp(n=48)
    ell = tt.BlockedEllOp.from_dense(a, block=(16, 16), device=CPU)
    kw = dict(check_period=10, accel=accel, eps_acc=1e-4)
    r_dense = _dense_direct(c, a, h, **kw)
    runs = [tt.solve_jit(_t(c), ell, _t(h), _cone(144),
                         tt.SolverParam(max_iter=100_000, method="direct",
                                        equil_iters=eq, **kw))
            for eq in (None, 10)]
    assert r_dense.status == tt.SolverStatus.CONVERGED
    obj = _objective(c, r_dense)
    for r in runs:
        assert r.status == tt.SolverStatus.CONVERGED
        assert abs(_objective(c, r) - obj) <= 1e-3 * (1.0 + abs(obj))


def test_direct_indirect_certificates():
    # unbounded / infeasible certificates survive the CG resolvent, as in
    # the JAX package
    lay = _cone(2)
    p = tt.SolverParam(max_iter=100_000, method="direct")
    op_inf = _custom(np.array([[1.0], [-1.0]]))
    r = tt.solve_jit(_t([1.0]), op_inf, _t([-5.0, -10.0]), lay, p)
    assert r.status == tt.SolverStatus.INFEASIBLE
    op_unb = _custom(np.array([[1.0], [1.0]]))
    r = tt.solve_jit(_t([1.0]), op_unb, _t([5.0, 10.0]), lay, p)
    assert r.status == tt.SolverStatus.UNBOUNDED
    rj = jt.solve_jit(jnp.asarray([1.0]),
                      jt.CustomOp(params=jnp.asarray([[1.0], [1.0]]), m=2,
                                  n=1, matvec_fn=lambda p_, x: p_ @ x),
                      jnp.asarray([5.0, 10.0]), jt.ConeLayout([jt.rpos(2)]),
                      jt.SolverParam(max_iter=100_000, method="direct"))
    assert r.iters == int(rj.iters)


def test_direct_indirect_ill_conditioned_f32():
    # f32 stress on the CG path: singular values over 3 decades, through a
    # BlockedEllOp with equilibration; the host f64 residual within 2e-3
    rng = np.random.default_rng(13)
    n = 96
    u_, _ = np.linalg.qr(rng.normal(size=(n, n)))
    v_, _ = np.linalg.qr(rng.normal(size=(n, n)))
    sv = 10.0 ** np.linspace(1.5, -1.5, n)
    g = (u_ * sv) @ v_.T
    x0 = rng.normal(size=n)
    h = np.concatenate([g @ x0 + rng.random(n) + 0.1,
                        np.full(2 * n, 10.0)]).astype(np.float32)
    g2 = np.concatenate([g, np.eye(n), -np.eye(n)]).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    ell = tt.BlockedEllOp.from_dense(g2, block=(32, 32), device=CPU)
    res = tt.solve_jit(_t(c, torch.float32), ell, _t(h, torch.float32),
                       _cone(3 * n),
                       tt.SolverParam(max_iter=200_000, method="direct",
                                      eps_acc=1e-3, check_period=10,
                                      equil_iters=10))
    assert res.status == tt.SolverStatus.CONVERGED
    x = res.x.double().numpy()
    r = g2.astype(np.float64) @ x - h.astype(np.float64)
    cri = np.linalg.norm(np.maximum(r, 0.0)) / (1.0 + np.linalg.norm(h))
    assert cri <= 2e-3


def test_solve_sequence_fast_profile_structured():
    # solve_sequence warm-starts through the fast profile's routing of a
    # structured operator to the indirect engine: the later solves of a
    # slowly varying sweep take fewer iterations than the cold first
    rng = np.random.default_rng(5)
    n = 12
    band = np.zeros((n, n))
    for i in range(n):
        band[i, max(0, i - 2):min(n, i + 2)] = rng.normal(
            size=min(n, i + 2) - max(0, i - 2))
    a = np.concatenate([band, np.eye(n), -np.eye(n)])
    h = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 5.0)])
    ell = tt.BlockedEllOp.from_dense(a, block=(4, 4), device=CPU)
    c0 = rng.normal(size=n)
    probs = [(_t(c0 * (1.0 + 0.01 * t)), ell, _t(h), _cone(3 * n))
             for t in range(4)]
    res = tt.solve_sequence(probs, tt.SolverParam(profile="fast",
                                                  eps_acc=1e-8,
                                                  max_iter=200_000))
    assert all(r.status == tt.SolverStatus.CONVERGED for r in res)
    assert res[1].iters < res[0].iters


def _ill_ell():
    c, a_full, h = _ill_scaled_banded()
    return c, tt.BlockedEllOp.from_dense(a_full, block=(64, 64),
                                         device=CPU), h, a_full


def test_indirect_cg_jacobi_preconditioner_ill_scaled():
    # on badly column-scaled data Jacobi PCG keeps every resolvent at its
    # tolerance where plain CG truncates at the cap by orders of
    # magnitude; SolveResult.diag says so, with the JAX package's numbers
    c, ell, h, a_full = _ill_ell()
    kw = dict(max_iter=600, eps_acc=1e-6, check_period=20, method="direct",
              accel="halpern")
    r_pc = tt.solve_jit(_t(c), ell, _t(h), _cone(384),
                        tt.SolverParam(cg_precond="jacobi", **kw))
    r_pl = tt.solve_jit(_t(c), ell, _t(h), _cone(384),
                        tt.SolverParam(cg_precond="none", **kw))
    worst_pc = float(r_pc.diag["cg_worst_rel"])
    worst_pl = float(r_pl.diag["cg_worst_rel"])
    tol = float(r_pc.diag["cg_tol"])
    assert worst_pc <= 10.0 * tol, (worst_pc, tol)
    assert worst_pl > 1e3 * worst_pc, (worst_pl, worst_pc)
    # 'auto' (the default) picks Jacobi for operators with col_sqsum: the
    # same iterate path
    r_auto = tt.solve_jit(_t(c), ell, _t(h), _cone(384), tt.SolverParam(**kw))
    assert torch.equal(r_auto.x, r_pc.x)
    rj = jt.solve_jit(jnp.asarray(c),
                      jt.BlockedEllOp.from_dense(a_full, block=(64, 64)),
                      jnp.asarray(h), jt.ConeLayout([jt.rpos(384)]),
                      jt.SolverParam(cg_precond="jacobi", **kw))
    np.testing.assert_allclose(worst_pc, float(rj.diag["cg_worst_rel"]),
                               rtol=1e-6)
    np.testing.assert_allclose(r_pc.x.numpy(), np.asarray(rj.x), atol=1e-8)


def test_indirect_ill_scaled_converges_with_equil_and_precond():
    c, ell, h, _ = _ill_ell()
    r = tt.solve_jit(_t(c), ell, _t(h), _cone(384),
                     tt.SolverParam(max_iter=20_000, eps_acc=1e-3,
                                    check_period=20, method="direct",
                                    accel="halpern", cg_precond="jacobi",
                                    equil_iters=10))
    assert r.status == tt.SolverStatus.CONVERGED
    assert float(r.diag["cg_worst_rel"]) <= 10.0 * float(r.diag["cg_tol"])


@pytest.mark.parametrize("chunk_iters", [None, 100],
                         ids=["whole", "chunked"])
def test_indirect_cg_truncation_warns_from_solve(chunk_iters):
    # solve() warns when CG hit its cap, after the whole solve and after
    # the chunked one (the checkpoint carries the worst residual)
    c, ell, h, _ = _ill_ell()
    p = tt.SolverParam(max_iter=300, eps_acc=1e-6, check_period=20,
                       method="direct", accel="halpern", cg_precond="none")
    with pytest.warns(RuntimeWarning, match="hit the iteration cap"):
        with pytest.raises(tt.SolverError):
            tt.solve(_t(c), ell, _t(h), _cone(384), p,
                     chunk_iters=chunk_iters)


def test_no_cg_warning_without_the_indirect_engine():
    c, a, h = _banded_box_lp(n=12)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tt.solve(_t(c), _t(a), _t(h), _cone(36),
                 tt.SolverParam(max_iter=100_000, method="direct"))


def test_indirect_cg_precond_matches_plain_well_scaled():
    # well-scaled banded instance: both modes converge to the same
    # solution (the preconditioner is then a near-constant rescale)
    rng = np.random.default_rng(3)
    n = 128
    a = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - 4), min(n, i + 5)
        a[i, lo:hi] = rng.normal(size=hi - lo)
    a_full = np.concatenate([a, np.eye(n), -np.eye(n)])
    h = np.concatenate([a @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 10.0)])
    c = rng.normal(size=n)
    ell = tt.BlockedEllOp.from_dense(a_full, block=(64, 64), device=CPU)
    kw = dict(max_iter=50_000, eps_acc=1e-8, check_period=20,
              method="direct", accel="halpern")
    r1 = tt.solve_jit(_t(c), ell, _t(h), _cone(3 * n),
                      tt.SolverParam(cg_precond="jacobi", **kw))
    r2 = tt.solve_jit(_t(c), ell, _t(h), _cone(3 * n),
                      tt.SolverParam(cg_precond="none", **kw))
    assert r1.status == r2.status == tt.SolverStatus.CONVERGED
    np.testing.assert_allclose(r1.x.numpy(), r2.x.numpy(), atol=1e-6)


def test_cg_precond_jacobi_requires_col_sqsum():
    rng = np.random.default_rng(1)
    g8 = rng.normal(size=(4, 8))
    amat = np.concatenate([g8, np.eye(8), -np.eye(8)])
    op = _custom(amat)
    b = _t(np.concatenate([g8 @ rng.normal(size=8) + rng.random(4) + 0.1,
                           np.full(16, 10.0)]))
    c = _t(rng.normal(size=8))
    with pytest.raises(NotImplementedError, match="col_sqsum"):
        tt.solve_jit(c, op, b, _cone(20),
                     tt.SolverParam(max_iter=100, method="direct",
                                    cg_precond="jacobi"))
    # 'auto' falls back to plain CG silently
    r = tt.solve_jit(c, op, b, _cone(20),
                     tt.SolverParam(max_iter=20_000, method="direct",
                                    accel="halpern"))
    assert r.status == tt.SolverStatus.CONVERGED


def test_scaling_spread_separates_measured_regimes():
    # the column 2-norm spread equals the JAX package's on every instance
    # class its calibration named (ill-scaled ~172, well-scaled ~1.2 and
    # ~2.9; the policy's threshold is 10)
    c, a_full, h = _ill_scaled_banded()
    rng = np.random.default_rng(3)
    n = 128
    a = np.concatenate([rng.normal(size=(n, n)), np.eye(n)])
    band = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - 4), min(n, i + 5)
        band[i, lo:hi] = rng.normal(size=hi - lo)
    wellb = np.concatenate([band, np.eye(n), -np.eye(n)])
    got = []
    for dense in (a_full, a, wellb):
        ours = scaling_spread(tt.BlockedEllOp.from_dense(dense, block=(64, 64),
                                                         device=CPU))
        theirs = jspread(jt.BlockedEllOp.from_dense(dense, block=(64, 64)))
        np.testing.assert_allclose(ours, theirs, rtol=1e-12)
        got.append(ours)
    assert got[0] > 100.0 and got[1] < 5.0 and got[2] < 5.0


def test_scaling_spread_is_one_sided_as_in_the_jax_package():
    # mirrors a known defect of the JAX package: the probe reads column
    # norms only, so a badly row-scaled instance with balanced columns
    # probes as well scaled and the auto policy stays off
    rng = np.random.default_rng(4)
    n = 64
    a = rng.normal(size=(2 * n, n))
    a *= 10.0 ** rng.uniform(-2, 2, size=(2 * n, 1))       # rows over 1e4
    a = a / np.linalg.norm(a, axis=0, keepdims=True)        # columns equal
    ell = tt.BlockedEllOp.from_dense(a, block=(32, 32), device=CPU)
    ours = scaling_spread(ell)
    assert ours < 1.0 + 1e-9
    np.testing.assert_allclose(
        ours, jspread(jt.BlockedEllOp.from_dense(a, block=(32, 32))),
        rtol=1e-12)
    assert tconic._maybe_auto_equil(tt.SolverParam(profile="fast"), ell,
                                    None).equil_iters is None


def test_auto_equil_policy_gating():
    # _maybe_auto_equil fires exactly when: fast profile, equil unset
    # (None), unsharded, a non-dense operator with the Ruiz trio
    c, a_full, h = _ill_scaled_banded()
    ill = tt.BlockedEllOp.from_dense(a_full, block=(64, 64), device=CPU)
    fast = tt.SolverParam(profile="fast")
    gate = tconic._maybe_auto_equil
    assert gate(fast, ill, None).equil_iters == 10
    assert gate(tt.SolverParam(), ill, None).equil_iters is None
    p5 = tt.SolverParam(profile="fast", equil_iters=5)
    assert gate(p5, ill, None).equil_iters == 5
    p0 = tt.SolverParam(profile="fast", equil_iters=0)
    assert gate(p0, ill, None).equil_iters == 0
    assert gate(fast, ill, object()).equil_iters is None
    dense = tt.DenseOp(_t(a_full))
    assert gate(fast, dense, None).equil_iters is None
    cust = _custom(a_full)
    assert gate(fast, cust, None).equil_iters is None
    # a stack with a CustomOp child has the trio at the top and raises
    # inside the probe: the policy stands down
    ones = torch.ones(a_full.shape[1], dtype=torch.float64)
    stack = tt.VStackOp((cust, tt.DiagOp(ones), tt.DiagOp(-ones)))
    assert gate(fast, stack, None).equil_iters is None
    assert np.isnan(stack._spread_memo)
    rng = np.random.default_rng(3)
    n = 128
    a = np.concatenate([rng.normal(size=(n, n)), np.eye(n)])
    well = tt.BlockedEllOp.from_dense(a, block=(64, 64), device=CPU)
    assert gate(fast, well, None).equil_iters is None
    # the JAX package's gate agrees case by case
    jill = jt.BlockedEllOp.from_dense(a_full, block=(64, 64))
    assert jconic._maybe_auto_equil(jt.SolverParam(profile="fast"), jill,
                                    None).equil_iters == 10


def test_auto_equil_probes_an_operator_once(monkeypatch):
    # the spread is kept on the operator: a sequence reusing one operator
    # pays the probe (one device reduction and one host read) once
    from totsu_tpu_torch.solver import scaling
    calls = []
    real = scaling.scaling_spread
    monkeypatch.setattr(scaling, "scaling_spread",
                        lambda op: calls.append(1) or real(op))
    c, ell, h, _ = _ill_ell()
    fast = tt.SolverParam(profile="fast")
    for _ in range(3):
        assert tconic._maybe_auto_equil(fast, ell, None).equil_iters == 10
    assert len(calls) == 1


def test_fast_profile_composite_customop_still_solves():
    # solve() with profile='fast' on VStackOp((CustomOp, DiagOp, DiagOp)):
    # the probe stands down and the indirect engine converges
    c, a, h = _banded_box_lp(n=48)
    ones = torch.ones(48, dtype=torch.float64)
    stack = tt.VStackOp((_custom(a[:48]), tt.DiagOp(ones),
                         tt.DiagOp(-ones)))
    r = tt.solve(_t(c), stack, _t(h), _cone(144),
                 tt.SolverParam(profile="fast", max_iter=100_000))
    assert r.status == tt.SolverStatus.CONVERGED


def test_fast_profile_auto_equil_ill_scaled_end_to_end():
    # plain solve(profile='fast') on the ill-scaled structured instance
    # converges: the auto policy adds the Ruiz sweeps
    c, ell, h, _ = _ill_ell()
    r = tt.solve(_t(c), ell, _t(h), _cone(384),
                 tt.SolverParam(profile="fast", max_iter=20_000,
                                eps_acc=1e-3, check_period=20))
    assert r.status == tt.SolverStatus.CONVERGED
    assert float(r.diag["cg_worst_rel"]) <= 10.0 * float(r.diag["cg_tol"])


def test_fast_profile_routes_structured_operators():
    # the fast profile sends non-dense operators to the indirect engine
    # with Halpern, leaving equil_iters unset, as the JAX package does;
    # the routed solve reaches the pdhg reference's objective in a fifth
    # of its iterations
    fp = tconic._resolve_fast_profile
    op = tt.CustomOp(params=torch.eye(3, dtype=torch.float64), m=3, n=3,
                     matvec_fn=lambda p, x: p @ x)
    p = fp(tt.SolverParam(profile="fast"), op, _cone(3))
    assert (p.method, p.accel, p.equil_iters) == ("direct", "halpern", None)
    ell = tt.BlockedEllOp.from_dense(np.eye(6), block=(2, 2), device=CPU)
    p = fp(tt.SolverParam(profile="fast"), ell, _cone(6))
    assert (p.method, p.accel, p.equil_iters) == ("direct", "halpern", None)
    jp = jconic._resolve_fast_profile(
        jt.SolverParam(profile="fast"),
        jt.BlockedEllOp.from_dense(np.eye(6), block=(2, 2)),
        jt.ConeLayout([jt.rpos(6)]))
    assert dataclasses.asdict(p) == dataclasses.asdict(
        interop.param_from_reference(jp))
    p = fp(tt.SolverParam(profile="fast", method="pdhg", relax=1.9), ell,
           _cone(6))
    assert p.method == "pdhg"
    rng = np.random.default_rng(11)
    n = 16
    band = np.zeros((n, n))
    for i in range(n):
        band[i, max(0, i - 2):min(n, i + 2)] = rng.normal(
            size=min(n, i + 2) - max(0, i - 2))
    a2 = np.concatenate([band, np.eye(n), -np.eye(n)])
    h2 = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                         np.full(2 * n, 5.0)])
    c2 = rng.normal(size=n)
    ell2 = tt.BlockedEllOp.from_dense(a2, block=(4, 4), device=CPU)
    r = tt.solve_jit(_t(c2), ell2, _t(h2), _cone(3 * n),
                     tt.SolverParam(profile="fast", eps_acc=1e-6,
                                    max_iter=200_000))
    r_ref = tt.solve_jit(_t(c2), _t(a2), _t(h2), _cone(3 * n),
                         tt.SolverParam(eps_acc=1e-6, max_iter=2_000_000))
    assert r.status == r_ref.status == tt.SolverStatus.CONVERGED
    np.testing.assert_allclose(_objective(c2, r), _objective(c2, r_ref),
                               rtol=1e-4, atol=1e-4)
    assert r.iters < r_ref.iters // 5


def test_matvec_dtype_requires_astype_support():
    # matvec_dtype composes with any operator that has astype; a
    # matrix-free CustomOp has no stored data to cast and raises
    op = _custom(np.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]]))
    with pytest.raises(NotImplementedError):
        tt.solve_jit(_t([-1.0, 0.0]), op, _t([6.0, 6.0, 1.0]), _cone(3),
                     tt.SolverParam(matvec_dtype="bfloat16"))


def test_fast_profile_psd_layouts_stay_on_pdhg():
    lay = tt.ConeLayout([tt.psd(4), tt.zero(3)])
    op = tt.BlockedEllOp.from_dense(np.eye(lay.dim), block=(13, 13),
                                    device=CPU)
    p = tconic._resolve_fast_profile(tt.SolverParam(profile="fast"), op, lay)
    assert p.method == "pdhg" and p.accel == "halpern"
    assert p.normalize is True


def test_structured_operators_pinned_to_the_iterate_dtype():
    # the port pins every operator to the iterate dtype (f64 tiles with f32
    # c and b solve in f32). This diverges from the JAX package on
    # purpose: it pins only a dense A, and the same call fails inside its
    # CG's while_loop. An operator that cannot be cast raises a clear
    # ValueError
    rng = np.random.default_rng(0)
    n = 32
    a = np.concatenate([rng.normal(size=(n, n)), np.eye(n)])
    c32 = np.ones(n, np.float32)
    b32 = np.ones(2 * n, np.float32)
    p = dict(method="direct", max_iter=100)
    ell64 = tt.BlockedEllOp.from_dense(a, block=(16, 16), device=CPU)
    r = tt.solve_jit(_t(c32, torch.float32), ell64, _t(b32, torch.float32),
                     _cone(2 * n), tt.SolverParam(**p))
    assert r.x.dtype == torch.float32
    with pytest.raises(TypeError, match="carry"):
        jt.solve_jit(jnp.asarray(c32),
                     jt.BlockedEllOp.from_dense(a, block=(16, 16)),
                     jnp.asarray(b32), jt.ConeLayout([jt.rpos(2 * n)]),
                     jt.SolverParam(**p))
    with pytest.raises(ValueError, match="cannot be cast"):
        tt.solve_jit(_t(c32, torch.float32), _custom(a),
                     _t(b32, torch.float32), _cone(2 * n),
                     tt.SolverParam(**p))
    # pdhg pins as well
    r = tt.solve_jit(_t(c32, torch.float32), ell64, _t(b32, torch.float32),
                     _cone(2 * n), tt.SolverParam(max_iter=100))
    assert r.x.dtype == torch.float32


def test_structured_operators_on_another_device_than_asked_raise():
    # every operator lives on one device; a stack's children must share
    # it, and data that is not a tensor goes where device= says
    op = tt.DiagOp([1.0, 2.0], device=CPU)
    assert op.device == torch.device(CPU) and op.dtype == torch.float64
    with pytest.raises(ValueError, match="not on device=cuda"):
        tt.DiagOp(torch.ones(2), device="cuda")
    with pytest.raises(ValueError, match="share a dtype"):
        tt.VStackOp((tt.DiagOp(torch.ones(2)),
                     tt.DiagOp(torch.ones(2, dtype=torch.float64))))
    with pytest.raises(ValueError, match="agree on axis 1"):
        tt.VStackOp((tt.DiagOp(torch.ones(2)), tt.DiagOp(torch.ones(3))))


def test_on_card_answers_for_any_operator():
    # the fast profile's question "does the solve run on the card" reads
    # any operator's device, not only a dense A's
    class OnCard(tt.LinOp):
        device = torch.device("cuda", 0)

    assert tconic._on_card(OnCard())
    assert not tconic._on_card(tt.DiagOp(torch.ones(2)))
    assert not tconic._on_card(tt.ZeroOp(2, 2, device=CPU))


def test_megakernel_takes_a_dense_a_only():
    # kernel='mega' on a structured operator raises, as in the JAX
    # package; 'auto' keeps the host loop
    c, a, h = _banded_box_lp(n=12)
    ell = tt.BlockedEllOp.from_dense(a.astype(np.float32), block=(4, 4),
                                     device=CPU)
    args = (_t(c, torch.float32), ell, _t(h, torch.float32), _cone(36))
    with pytest.raises(ValueError, match="kernel='mega' requires a dense"):
        tt.solve_jit(*args, tt.SolverParam(kernel="mega", max_iter=20))
    r = tt.solve_jit(*args, tt.SolverParam(kernel="auto", max_iter=20))
    assert r.iters == 20
