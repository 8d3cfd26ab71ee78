"""The direct engine of the PyTorch port against the JAX package.

Douglas-Rachford on the homogeneous self-dual embedding, plain and
Halpern (``method='direct'``). Each problem is made once with numpy and
handed to both packages. In f64 the port's host loop follows the JAX
``lax.while_loop`` term by term (Cholesky solve of I + A^T A on both
sides, a lower factor here, an upper one there), so the status and the
iteration count agree exactly and x, y to roundoff (1e-8). In f32 both
build the Newton-Schulz inverse and refine twice per solve; the sums run
in other orders, so the iteration counts may differ by a check period.
The second half twins the dense tests of ``tests/test_direct.py``.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.solver import direct

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))


def _lp(n=12, seed=0):
    """bench.make_lp's shape (random inequalities plus the box |x| <= 10)
    at a small n: A (4n, n), R+."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    eye = np.eye(n)
    a = np.concatenate([g, eye, -eye])
    b = np.concatenate([h, np.full(2 * n, 10.0)])
    return rng.normal(size=n), a, b, jt.ConeLayout([jt.rpos(4 * n)])


def _qp():
    # the diagonal-P QP of bench.make_qp at n = 6: RSOC epigraph + R+
    rng = np.random.default_rng(1)
    n = 6
    p = jt.problems.qp(np.diag(rng.random(n) + 0.01), rng.random(n),
                       g=-rng.random((n, n)), h=-rng.random(n))
    return (np.asarray(p.c), np.asarray(p.a.a), np.asarray(p.b), p.cone)


def _socp():
    # tests/test_direct.py's SOCP: min x1 + x2 s.t. ||x|| <= sqrt(2)
    return (np.array([1.0, 1.0]),
            np.array([[0.0, 0.0], [-1.0, 0.0], [0.0, -1.0]]),
            np.array([np.sqrt(2.0), 0.0, 0.0]), jt.ConeLayout([jt.soc(3)]))


def _gp():
    # tests/test_problems.py's analytic GP: min 1/(xy) s.t. x + y <= 1
    p, _ = jt.problems.gp([[1.0], [1.0, 1.0]],
                          [[[-1.0, -1.0]], [[1.0, 0.0], [0.0, 1.0]]])
    return (np.asarray(p.c), np.asarray(p.a.a), np.asarray(p.b), p.cone)


def _pow():
    # examples/growthport_powexp.py at n = 6, S = 4: zero(1), R+(7), 3
    # pow(1/2) blocks and 6 exp blocks
    import growthport_powexp
    rng = np.random.default_rng(0)
    returns = 1.0 + 0.3 * rng.standard_normal((4, 6)) ** 2 \
        - 0.1 * rng.random((4, 6))
    c, a, b, lay, _ = growthport_powexp.build_problem(returns, -1.2)
    return np.asarray(c), np.asarray(a), np.asarray(b), lay


PROBLEMS = {"lp": _lp, "qp": _qp, "socp": _socp, "gp": _gp, "pow": _pow}


def _both(c, a, b, lay, pj, warm=None, dtype=np.float64):
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    rj = jt.solve_jit(jnp.asarray(c, jdt), jnp.asarray(a, jdt),
                      jnp.asarray(b, jdt), lay, pj, warm_start=warm)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=tdt)
    warm_t = None if warm is None else tuple(
        torch.from_numpy(np.array(w)) for w in warm)
    rt = tt.solve_jit(ct, at, bt, interop.cone_from_reference(lay),
                      interop.param_from_reference(pj), warm_start=warm_t)
    return rj, rt


def _assert_f64_parity(rj, rt):
    assert rt.status == int(rj.status)
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("accel", ["", "halpern"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_direct_matches_jax_f64(name, accel):
    c, a, b, lay = PROBLEMS[name]()
    pj = jt.SolverParam(max_iter=20_000, method="direct", eps_acc=1e-7,
                        check_period=5, accel=accel)
    rj, rt = _both(c, a, b, lay, pj)
    assert int(rj.status) == tt.SolverStatus.CONVERGED
    _assert_f64_parity(rj, rt)


@pytest.mark.parametrize("accel", ["", "halpern"])
@pytest.mark.parametrize("opts", [
    dict(normalize=False), dict(equil_iters=0), dict(equil_iters=10),
    dict(normalize=False, equil_iters=10)],
    ids=["normalize_off", "equil_0", "equil_10", "normalize_off_equil_10"])
@pytest.mark.parametrize("name", ["lp", "gp"])
def test_direct_options_match_jax_f64(name, opts, accel):
    c, a, b, lay = PROBLEMS[name]()
    pj = jt.SolverParam(max_iter=20_000, method="direct", eps_acc=1e-7,
                        check_period=5, accel=accel, **opts)
    rj, rt = _both(c, a, b, lay, pj)
    assert int(rj.status) == tt.SolverStatus.CONVERGED
    _assert_f64_parity(rj, rt)


@pytest.mark.parametrize("accel", ["", "halpern"])
@pytest.mark.parametrize("opts", [{}, dict(equil_iters=10)],
                         ids=["default", "equil_10"])
def test_direct_warm_start_at_solution_matches_jax(opts, accel):
    # the seed (x*, y*) with v0 = (0, Pi_K(b - A x*), 0) is a DR fixed
    # point: 0 iterations under both accels, in both packages
    c, a, b, lay = _lp(seed=2)
    pj = jt.SolverParam(max_iter=20_000, method="direct", eps_acc=1e-6,
                        check_period=5, accel=accel, **opts)
    rj, rt = _both(c, a, b, lay, pj)
    _assert_f64_parity(rj, rt)
    rj2, rt2 = _both(c, a, b, lay, pj,
                     warm=(np.asarray(rj.x), np.asarray(rj.y)))
    assert rt2.converged and rt2.iters == int(rj2.iters) == 0
    _assert_f64_parity(rj2, rt2)


@pytest.mark.parametrize("accel", ["", "halpern"])
@pytest.mark.parametrize("name", ["lp", "gp", "pow"])
def test_direct_matches_jax_f32(name, accel):
    # f32: both packages build the Newton-Schulz inverse and refine twice
    # per solve. Seen on these cases: equal iteration counts; the bound
    # is two check periods
    c, a, b, lay = PROBLEMS[name]()
    pj = jt.SolverParam(max_iter=20_000, method="direct", eps_acc=1e-4,
                        check_period=10, accel=accel)
    rj, rt = _both(c, a, b, lay, pj, dtype=np.float32)
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert abs(rt.iters - int(rj.iters)) <= 2 * pj.check_period
    xj = np.asarray(rj.x, np.float64)
    np.testing.assert_allclose(rt.x.double().numpy(), xj, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(xj).max()))


@pytest.mark.parametrize("name", ["lp", "gp"])
def test_newton_schulz_matches_jax(name, monkeypatch):
    # the JAX engine's inverse of M = I + A^T A (its f32 cache, returned
    # with the resume state) and its step count (the Newton-Schulz
    # while_loop's counter) against the port's helper on the same A
    c, a, b, lay = PROBLEMS[name]()
    real = jax.lax.while_loop
    seen = {}

    def spy(cond, body, init):
        out = real(cond, body, init)
        if cond.__name__ == "ns_cond":
            seen["steps"] = int(out[3])
        return out

    monkeypatch.setattr(jax.lax, "while_loop", spy)
    rj = jt.solve_jit(jnp.asarray(c, jnp.float32), jnp.asarray(a, jnp.float32),
                      jnp.asarray(b, jnp.float32), lay,
                      jt.SolverParam(method="direct", max_iter=1,
                                     return_state=True))
    prec_j = np.asarray(rj.state.aux["prec"], np.float64)
    cache = direct.spd_cache(torch.tensor(a, dtype=torch.float32))
    assert not cache.cholesky and cache.refine_steps == 2
    prec_t = cache.factor.double().numpy()
    rel = np.linalg.norm(prec_t - prec_j) / np.linalg.norm(prec_j)
    assert rel <= 1e-5, rel
    assert abs(cache.ns_steps - seen["steps"]) <= 1


def test_spd_cache_f64_is_cholesky():
    c, a, b, lay = _lp()
    at = torch.tensor(a)
    cache = direct.spd_cache(at)
    assert cache.cholesky and cache.refine_steps == 0
    m = torch.eye(a.shape[1], dtype=torch.float64) + at.T @ at
    r = torch.arange(a.shape[1], dtype=torch.float64)
    np.testing.assert_allclose((m @ cache.apply_inv(r)).numpy(), r.numpy(),
                               atol=1e-10)


@pytest.fixture
def caller_precision():
    """Sets the caller's float32 matmul precision to 'high' (TF32 allowed)
    and puts the process's setting back after the test."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(saved)


def test_precision_pin_full_f32_and_restored(caller_precision, monkeypatch):
    # every product of the engine runs with TF32 off, and the caller's
    # 'high' reads back afterwards, also after a raise inside the engine
    seen = []
    real = direct._matmul

    def spy(x, y):
        seen.append(torch.get_float32_matmul_precision())
        return real(x, y)

    monkeypatch.setattr(direct, "_matmul", spy)
    c, a, b, lay = _lp()
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=torch.float32)
    cone = interop.cone_from_reference(lay)
    res = tt.solve_jit(ct, at, bt, cone,
                       tt.SolverParam(method="direct", max_iter=40,
                                      check_period=10))
    assert res.iters > 0 and len(seen) > 10
    assert set(seen) == {"highest"}
    assert torch.get_float32_matmul_precision() == "high"

    def boom(x, y):
        raise RuntimeError("boom")

    monkeypatch.setattr(direct, "_matmul", boom)
    with pytest.raises(RuntimeError, match="boom"):
        tt.solve_jit(ct, at, bt, cone, tt.SolverParam(method="direct"))
    assert torch.get_float32_matmul_precision() == "high"


def test_direct_unported_raise():
    # the indirect engine is ported: method='direct' on an operator that is
    # not a DenseOp runs CG instead of raising; what still raises is an
    # operator without the LinOp contract (no matvec), from the base class
    c, a, b, lay = _lp()
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu")
    cone = interop.cone_from_reference(lay)

    class Op(tt.LinOp):
        shape = at.shape
        device = at.device

    with pytest.raises(NotImplementedError):
        direct.solve_direct_jit(ct, Op(), bt, cone,
                                tt.SolverParam(method="direct"))

    class MatOp(Op):
        def matvec(self, x):
            return at @ x

        def rmatvec(self, y):
            return y @ at

    p = tt.SolverParam(method="direct", max_iter=100_000)
    res = direct.solve_direct_jit(ct, MatOp(), bt, cone, p)
    ref = direct.solve_direct_jit(ct, tt.DenseOp(at), bt, cone, p)
    assert res.status == ref.status == tt.SolverStatus.CONVERGED
    np.testing.assert_allclose(float(ct @ res.x), float(ct @ ref.x),
                               rtol=1e-4)


# ---- twins of tests/test_direct.py (dense cases), on the port

DIRECT = tt.SolverParam(max_iter=100_000, method="direct")


def _t(*xs):
    return [torch.tensor(np.asarray(x, dtype=np.float64)) for x in xs]


def test_direct_nostd_lp():
    c, a, b = _t([-1.0, 0.0], [[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]],
                 [6.0, 6.0, 1.0])
    res = tt.solve(c, a, b, tt.ConeLayout([tt.rpos(3)]), DIRECT)
    np.testing.assert_allclose(res.x.numpy(), [2.0, 2.0], atol=1e-4)
    assert res.iters < 100


def test_direct_all_problem_classes():
    p = tt.problems.qp(np.eye(2), [1.0, 2.0], g=[[-0.5, -1.0 / 3.0]],
                       h=[-1.0], device="cpu")
    r = tt.solve(p.c, p.a, p.b, p.cone, DIRECT)
    np.testing.assert_allclose(r.x.numpy()[:2], [2.0, 0.0], atol=1e-3)
    # SDP (the core reference test)
    c, a, b = _t([1.0], [[0.0], [-np.sqrt(2.0)], [-3.0]], [1.0, 0.0, 10.0])
    r = tt.solve(c, a, b, tt.ConeLayout([tt.psd(2)]), DIRECT)
    np.testing.assert_allclose(float(r.x[0]), -2.0, atol=1e-3)
    c, a, b = _t([1.0, 1.0], [[0.0, 0.0], [-1.0, 0.0], [0.0, -1.0]],
                 [np.sqrt(2.0), 0.0, 0.0])
    r = tt.solve(c, a, b, tt.ConeLayout([tt.soc(3)]), DIRECT)
    np.testing.assert_allclose(r.x.numpy(), [-1.0, -1.0], atol=1e-3)


@pytest.mark.parametrize("b,status", [
    ([-5.0, -10.0], tt.SolverStatus.INFEASIBLE),
    ([5.0, 10.0], tt.SolverStatus.UNBOUNDED),
], ids=["infeasible", "unbounded"])
def test_direct_certificates(b, status):
    a = [[1.0], [-1.0]] if status == tt.SolverStatus.INFEASIBLE \
        else [[1.0], [1.0]]
    c, a, b = _t([1.0], a, b)
    with pytest.raises(tt.SolverError) as ei:
        tt.solve(c, a, b, tt.ConeLayout([tt.rpos(2)]), DIRECT)
    assert ei.value.status == status


def test_direct_matches_pdhg_on_random_lp():
    rng = np.random.default_rng(0)
    n = 30
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    eye = np.eye(n)
    c, a, b = _t(rng.normal(size=n), np.concatenate([g, eye, -eye]),
                 np.concatenate([h, 10 * np.ones(2 * n)]))
    lay = tt.ConeLayout([tt.rpos(4 * n)])
    rd = tt.solve_jit(c, a, b, lay,
                      tt.SolverParam(max_iter=200_000, method="direct",
                                     equil_iters=10))
    # the pdhg side runs in the JAX package (the port's host loop takes
    # minutes for its iterations on one core; tests/test_torch_solver.py
    # holds the two pdhg loops together)
    rp = jt.solve_jit(*(jnp.asarray(x.numpy()) for x in (c, a, b)),
                      jt.ConeLayout([jt.rpos(4 * n)]),
                      jt.SolverParam(max_iter=400_000))
    assert rd.status == int(rp.status) == tt.SolverStatus.CONVERGED
    np.testing.assert_allclose(rd.x.numpy(), np.asarray(rp.x), atol=1e-3)
    assert rd.iters < int(rp.iters) / 3


def test_direct_halpern_converges_fewer_iters():
    rng = np.random.default_rng(3)
    n = 40
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    c, a, b = _t(rng.normal(size=n), g, h)
    lay = tt.ConeLayout([tt.rpos(2 * n)])
    plain = tt.solve_jit(c, a, b, lay,
                         tt.SolverParam(max_iter=200_000, method="direct",
                                        check_period=10))
    halp = tt.solve_jit(c, a, b, lay,
                        tt.SolverParam(max_iter=200_000, method="direct",
                                       check_period=10, accel="halpern"))
    assert plain.converged and halp.converged
    np.testing.assert_allclose(float(c @ halp.x), float(c @ plain.x),
                               rtol=1e-4, atol=1e-4)
    assert halp.iters <= plain.iters


@pytest.mark.parametrize("kw", [dict(accel="halpern", relax=1.5),
                                dict(accel="restart")],
                         ids=["halpern_relaxed", "restart"])
def test_direct_halpern_requires_unrelaxed(kw):
    c, a, b = _t(np.ones(2), np.eye(2), np.ones(2))
    with pytest.raises(ValueError):
        tt.solve_jit(c, a, b, tt.ConeLayout([tt.rpos(2)]),
                     tt.SolverParam(method="direct", **kw))


def test_direct_normalize_off_still_solves():
    c, a, b = _t([-1.0, 0.0], [[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]],
                 [6.0, 6.0, 1.0])
    res = tt.solve(c, a, b, tt.ConeLayout([tt.rpos(3)]),
                   tt.SolverParam(max_iter=100_000, method="direct",
                                  normalize=False))
    np.testing.assert_allclose(res.x.numpy(), [2.0, 2.0], atol=1e-4)


@pytest.mark.parametrize("accel", ["", "halpern"])
def test_direct_warm_start_fixed_point(accel):
    rng = np.random.default_rng(11)
    n = 20
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    c, a, b = _t(rng.normal(size=n), g, h)
    lay = tt.ConeLayout([tt.rpos(2 * n)])
    p = tt.SolverParam(max_iter=200_000, method="direct", check_period=10,
                       accel=accel)
    cold = tt.solve(c, a, b, lay, p)
    warm = tt.solve(c, a, b, lay, p, warm_start=(cold.x, cold.y))
    assert warm.iters == 0


def test_direct_ill_conditioned_f32():
    # singular values over 4 decades: cond(I + A^T A) ~ 1e8 in f32; the
    # Newton-Schulz inverse with two refinement steps must converge, and
    # the KKT residual by hand in f64 holds
    rng = np.random.default_rng(13)
    n = 200
    u_, _ = np.linalg.qr(rng.normal(size=(2 * n, n)))
    v_, _ = np.linalg.qr(rng.normal(size=(n, n)))
    g = (u_ * 10.0 ** np.linspace(2, -2, n)) @ v_.T
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    eye = np.eye(n)
    g2 = np.concatenate([g, eye, -eye]).astype(np.float32)
    h2 = np.concatenate([h, np.full(2 * n, 10.0)]).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    res = tt.solve_jit(*(torch.from_numpy(x) for x in (c, g2, h2)),
                       tt.ConeLayout([tt.rpos(4 * n)]),
                       tt.SolverParam(max_iter=200_000, method="direct",
                                      eps_acc=1e-3, check_period=10,
                                      equil_iters=10))
    assert res.converged
    x = res.x.double().numpy()
    r = g2.astype(np.float64) @ x - h2.astype(np.float64)
    cri = np.linalg.norm(np.maximum(r, 0.0)) / (1.0 + np.linalg.norm(h2))
    assert cri <= 2e-3
