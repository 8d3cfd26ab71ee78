"""Solution polishing in the PyTorch port against the JAX package.

Twins of ``tests/test_polish.py``, one test each, on the CPU. Every
instance is made once with numpy and handed to both packages. Two kinds
of comparison:

* the polish alone: both packages' ``polish`` take the same converged
  point (the JAX solve's x and y) and must return the same polished
  point (x and y within 1e-9, the same ``polished`` flag, residuals
  within 1e-9 absolute): the port's copy is the same host f64 numpy;
* the port's own solve: ``solve(..., polish=True)`` in the port must
  meet the JAX test's contract (residuals to 1e-9) and land within 1e-9
  of the JAX package's polished x and y. The two f32 solves stop at
  different iterates; the polish takes both to the same vertex.

The port returns a polished x and y as f64 tensors on A's device,
whatever the solve's dtype (the JAX package, under x64 as in these
tests, returns f64 too): rounding them to f32 would undo the polish.
"""

import types
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
from totsu_tpu.solver.polish import polish as jpolish
import totsu_tpu_torch as tt
from totsu_tpu_torch.solver.polish import polish as tpolish
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

#: x, y and residuals: the polished points agree to this (absolute)
TOL = 1e-9
CPU = torch.device("cpu")


def _bench_lp(n=100, seed=1):
    rng = np.random.default_rng(seed)
    m = 2 * n
    g = rng.normal(size=(m, n))
    h = g @ rng.normal(size=n) + rng.random(m) + 0.1
    eye = np.eye(n)
    g = np.concatenate([g, eye, -eye]).astype(np.float32)
    h = np.concatenate([h, np.full(2 * n, 10.0)]).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    return c, g, h, [("rpos", 4 * n)]


def _lays(spec):
    """The same layout in both packages from (kind, dim) pairs."""
    def mk(mod, kind, dim):
        if kind == "psd":
            return mod.psd(dim)
        return getattr(mod, kind)(dim)
    return (jt.ConeLayout([mk(jt, k, d) for k, d in spec]),
            tt.ConeLayout([mk(tt, k, d) for k, d in spec]))


def _t(v):
    return torch.from_numpy(np.array(v))


def _fast_param(mod):
    return mod.SolverParam(max_iter=300_000, eps_acc=1e-3, check_period=10,
                           profile="fast")


def _same_polish(res_j, c, a, b, spec):
    """Both packages' polish on the JAX solve's point: the same result."""
    lay_j, lay_t = _lays(spec)
    pj = jpolish(res_j, c, a, b, lay_j)
    point = types.SimpleNamespace(x=_t(np.asarray(res_j.x)),
                                  y=_t(np.asarray(res_j.y)))
    pt = tpolish(point, _t(c), _t(a), _t(b), lay_t)
    assert pt.polished == pj.polished
    np.testing.assert_allclose(pt.x, pj.x, rtol=0, atol=TOL)
    np.testing.assert_allclose(pt.y, pj.y, rtol=0, atol=TOL)
    for f in ("pri_res", "dual_res", "obj"):
        np.testing.assert_allclose(getattr(pt, f), getattr(pj, f), rtol=0,
                                   atol=TOL)
    return pj, pt


def _close_to(res_t, x_j, y_j):
    """The port's polished solve within TOL of the JAX package's point,
    as f64 tensors on A's device; where the JAX package kept its f32
    solve (the polish found no better point), the port must keep its
    own too."""
    if np.asarray(x_j).dtype == np.float32:
        assert res_t.x.dtype == torch.float32
        return
    assert res_t.x.dtype == torch.float64 and res_t.x.device == CPU
    assert res_t.y.dtype == torch.float64 and res_t.y.device == CPU
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(x_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(res_t.y.numpy(), np.asarray(y_j), rtol=0,
                               atol=TOL)


def test_polish_f32_lp_to_1e9():
    c, g, h, spec = _bench_lp()
    lay_j, lay_t = _lays(spec)
    res_j = jt.solve(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), lay_j,
                     _fast_param(jt))
    pj, _ = _same_polish(res_j, c, g, h, spec)
    res_t = tt.solve(_t(c), _t(g), _t(h), lay_t, _fast_param(tt))
    assert res_t.x.dtype == torch.float32
    pt = tpolish(res_t, _t(c), _t(g), _t(h), lay_t)
    assert pt.polished
    assert pt.pri_res <= 1e-9
    assert pt.dual_res <= 1e-9
    np.testing.assert_allclose(pt.x, pj.x, rtol=0, atol=TOL)
    np.testing.assert_allclose(pt.y, pj.y, rtol=0, atol=TOL)


def test_polish_wired_into_solve_facade():
    c, g, h, spec = _bench_lp(seed=2)
    lay_j, lay_t = _lays(spec)
    ref_j = jt.solve(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), lay_j,
                     _fast_param(jt), polish=True)
    plain = tt.solve(_t(c), _t(g), _t(h), lay_t, _fast_param(tt))
    ref = tt.solve(_t(c), _t(g), _t(h), lay_t, _fast_param(tt), polish=True)
    assert float(ref.cri_pri) <= 1e-9
    assert float(ref.cri_dual) <= 1e-9
    assert ref.iters == plain.iters and ref.status == plain.status
    # the polished point is at least as good an objective
    c64 = c.astype(np.float64)
    assert float(c64 @ ref.x.numpy()) <= \
        float(c64 @ plain.x.double().numpy()) + 1e-6
    _close_to(ref, ref_j.x, ref_j.y)
    for f in ("cri_pri", "cri_dual", "cri_gap"):
        np.testing.assert_allclose(float(getattr(ref, f)),
                                   float(getattr(ref_j, f)), rtol=0,
                                   atol=TOL)


def test_polish_soc_active_set():
    # min x1 + x2 s.t. ||(x1, x2)|| <= sqrt(2): boundary SOC at (-1, -1)
    c = np.array([1.0, 1.0], dtype=np.float32)
    a = np.array([[0.0, 0.0], [-1.0, 0.0], [0.0, -1.0]], dtype=np.float32)
    b = np.array([np.sqrt(2.0, dtype=np.float32), 0.0, 0.0],
                 dtype=np.float32)
    spec = [("soc", 3)]
    lay_j, lay_t = _lays(spec)

    def param(mod):
        return mod.SolverParam(max_iter=300_000, eps_acc=1e-3,
                               check_period=10)

    res_j = jt.solve(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay_j,
                     param(jt))
    _same_polish(res_j, c, a, b, spec)
    res_t = tt.solve(_t(c), _t(a), _t(b), lay_t, param(tt))
    pr = tpolish(res_t, c, a, b, lay_t)
    assert pr.polished
    np.testing.assert_allclose(pr.x, [-1.0, -1.0], atol=1e-8)
    assert pr.pri_res <= 1e-8 and pr.dual_res <= 1e-8


def test_polish_mixed_zero_rpos_soc():
    # an equality + inequality + SOC block: polish never degrades
    rng = np.random.default_rng(3)
    n = 6
    a_eq = rng.normal(size=(2, n))
    x_feas = rng.normal(size=n)
    b_eq = a_eq @ x_feas
    g = rng.normal(size=(4, n))
    h = g @ x_feas + 1.0
    soc_rows = np.concatenate([np.zeros((1, n)), -np.eye(n)[:3]], axis=0)
    soc_rhs = np.concatenate([[10.0], np.zeros(3)])
    a = np.concatenate([a_eq, g, soc_rows]).astype(np.float32)
    b = np.concatenate([b_eq, h, soc_rhs]).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    spec = [("zero", 2), ("rpos", 4), ("soc", 4)]
    lay_j, lay_t = _lays(spec)

    def param(mod):
        return mod.SolverParam(max_iter=500_000, eps_acc=1e-4,
                               check_period=10)

    res_j = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                         lay_j, param(jt))
    assert int(res_j.status) == jt.SolverStatus.CONVERGED
    _same_polish(res_j, c, a, b, spec)
    res_t = tt.solve_jit(_t(c), _t(a), _t(b), lay_t, param(tt))
    assert res_t.status == tt.SolverStatus.CONVERGED
    pr = tpolish(res_t, c, a, b, lay_t)
    assert pr.pri_res <= max(1e-8, 10 * float(res_t.cri_pri)) \
        or not pr.polished


def test_polish_sdp_eigenspace_active_face():
    # the reference 1-variable SDP (x* = -2) solved coarsely in f32
    sq2 = np.sqrt(2.0)
    c = np.asarray([1.0], np.float32)
    a = np.asarray([[0.0], [-sq2], [-3.0]], np.float32)
    b = np.asarray([1.0, 0.0, 10.0], np.float32)
    lay_j = jt.ConeLayout([jt.psd(2)])
    lay_t = tt.ConeLayout([tt.psd(2)])

    def param(mod):
        return mod.SolverParam(max_iter=200_000, eps_acc=1e-3,
                               check_period=10)

    res_j = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                         lay_j, param(jt))
    assert int(res_j.status) == jt.SolverStatus.CONVERGED
    _same_polish(res_j, c, a, b, [("psd", 2)])
    res_t = tt.solve_jit(_t(c), _t(a), _t(b), lay_t, param(tt))
    assert res_t.status == tt.SolverStatus.CONVERGED
    pr = tpolish(res_t, c, a, b, lay_t)
    assert pr.polished
    assert abs(pr.obj - (-2.0)) < 1e-7
    assert max(pr.pri_res, pr.dual_res) < 1e-7


def test_polish_random_sdp_improves():
    # a random small SDP with a diagonal LMI: never degrades
    rng = np.random.default_rng(9)
    k, n = 4, 3
    from totsu_tpu_torch.ops import sympack
    fs = []
    for _ in range(n):
        mm = rng.normal(size=(k, k))
        fs.append((mm + mm.T) / 2)
    a = np.stack([sympack.pack(_t(-f), scaled=True).numpy() for f in fs],
                 axis=1)
    b = sympack.pack(_t(np.eye(k) * 2.0), scaled=True).numpy()
    c = rng.normal(size=n)
    lay_j = jt.ConeLayout([jt.psd(k)])
    lay_t = tt.ConeLayout([tt.psd(k)])

    def param(mod):
        return mod.SolverParam(max_iter=500_000, eps_acc=1e-4,
                               check_period=10)

    f32 = [np.asarray(v, np.float32) for v in (c, a, b)]
    res_j = jt.solve_jit(*(jnp.asarray(v) for v in f32), lay_j, param(jt))
    assert int(res_j.status) == jt.SolverStatus.CONVERGED
    _same_polish(res_j, c, a, b, [("psd", k)])
    res_t = tt.solve_jit(*(_t(v) for v in f32), lay_t, param(tt))
    assert res_t.status == tt.SolverStatus.CONVERGED
    pr = tpolish(res_t, c, a, b, lay_t)
    x0 = res_t.x.double().numpy()
    y0 = res_t.y.double().numpy()
    from totsu_tpu_torch.solver.polish import _unpack_np
    s0 = b - a @ x0
    pri0 = max(-float(np.linalg.eigvalsh(_unpack_np(s0, k))[0]), 0.0)
    dual0 = float(np.linalg.norm(c + a.T @ y0))
    assert max(pr.pri_res, pr.dual_res) <= max(pri0, dual0) * 1.001 + 1e-12


def test_polish_unsupported_cone_warns():
    # exp cones cannot be polished: the no-op is loud, in both packages
    from totsu_tpu.solver.conic import SolveResult as JResult
    fake_j = JResult(x=jnp.zeros(2), y=jnp.zeros(3), status=jnp.asarray(1),
                     iters=jnp.asarray(1), cri_pri=jnp.asarray(0.0),
                     cri_dual=jnp.asarray(0.0), cri_gap=jnp.asarray(0.0),
                     cri_unbdd=jnp.asarray(np.inf),
                     cri_infeas=jnp.asarray(np.inf))
    fake_t = tt.SolveResult(x=torch.zeros(2), y=torch.zeros(3), status=1,
                            iters=1, cri_pri=torch.tensor(0.0),
                            cri_dual=torch.tensor(0.0),
                            cri_gap=torch.tensor(0.0),
                            cri_unbdd=torch.tensor(np.inf),
                            cri_infeas=torch.tensor(np.inf))
    with pytest.warns(RuntimeWarning, match="does not support") as rec_j:
        pj = jpolish(fake_j, np.zeros(2), np.zeros((3, 2)), np.zeros(3),
                     jt.ConeLayout([jt.expc(1)]))
    with pytest.warns(RuntimeWarning, match="does not support") as rec_t:
        pt = tpolish(fake_t, np.zeros(2), np.zeros((3, 2)), np.zeros(3),
                     tt.ConeLayout([tt.expc(1)]))
    assert not pj.polished and not pt.polished
    assert str(rec_t[0].message) == str(rec_j[0].message)


def test_polish_refreshes_certificate_criteria():
    # the polished result's certificate fields are recomputed at the
    # polished point (tau = 1, s = b - A x), as in the JAX package
    c, g, h, spec = _bench_lp(seed=3)
    lay_j, lay_t = _lays(spec)
    res_j = jt.solve(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), lay_j,
                     _fast_param(jt), polish=True)
    res = tt.solve(_t(c), _t(g), _t(h), lay_t, _fast_param(tt), polish=True)
    _close_to(res, res_j.x, res_j.y)
    cn = np.asarray(c, np.float64)
    bn = np.asarray(h, np.float64)
    gx = float(cn @ res.x.numpy())
    gy = float(bn @ res.y.numpy())
    if -gx > 1e-12:
        exp_unbdd = np.linalg.norm(bn) * np.linalg.norm(cn) / (-gx)
        np.testing.assert_allclose(float(res.cri_unbdd), exp_unbdd,
                                   rtol=1e-6)
    else:
        assert np.isinf(float(res.cri_unbdd))
    aty = np.asarray(g, np.float64).T @ res.y.numpy()
    if -gy > 1e-12:
        exp_infeas = np.linalg.norm(aty) * np.linalg.norm(bn) / (-gy)
        np.testing.assert_allclose(float(res.cri_infeas), exp_infeas,
                                   rtol=1e-6)
    else:
        assert np.isinf(float(res.cri_infeas))
    if res.x.dtype == torch.float64:
        for f in ("cri_unbdd", "cri_infeas"):
            np.testing.assert_allclose(float(getattr(res, f)),
                                       float(getattr(res_j, f)), rtol=1e-6)
            assert getattr(res, f).dtype == torch.float64


def test_polish_rsoc_qp_reduction():
    # the QP epigraph reduction (an RSOC block) polishes with no warning
    rng = np.random.default_rng(4)
    n = 30
    f = rng.normal(size=(n, n)).astype(np.float32) / np.sqrt(n)
    p = f.T @ f + 0.1 * np.eye(n, dtype=np.float32)
    q = rng.random(n).astype(np.float32)
    g = rng.normal(size=(n, n)).astype(np.float32)
    h = (g @ rng.normal(size=n) + rng.random(n) + 0.1).astype(np.float32)
    prob_j = jt.problems.qp(p, q, g=g, h=h)
    res_j = jt.solve(prob_j.c, prob_j.a, prob_j.b, prob_j.cone,
                     _fast_param(jt), polish=True)
    prob = tt.problems.qp(p, q, g=g, h=h, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # any warning -> failure
        res = tt.solve(prob.c, prob.a, prob.b, prob.cone, _fast_param(tt),
                       polish=True)
    assert float(res.cri_pri) <= 1e-9
    assert float(res.cri_dual) <= 1e-9
    _close_to(res, res_j.x, res_j.y)


def test_polish_rsoc_standalone():
    # min -x2 s.t. (1, x1, x2) in RSOC, x1 <= 2: optimum (2, 2) on the
    # RSOC boundary
    c = np.array([0.0, -1.0], dtype=np.float32)
    a = np.array([[0.0, 0.0], [-1.0, 0.0], [0.0, -1.0], [1.0, 0.0]],
                 dtype=np.float32)
    b = np.array([1.0, 0.0, 0.0, 2.0], dtype=np.float32)
    spec = [("rsoc", 3), ("rpos", 1)]
    lay_j, lay_t = _lays(spec)

    def param(mod):
        return mod.SolverParam(max_iter=300_000, eps_acc=1e-3)

    res_j = jt.solve(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay_j,
                     param(jt), polish=True)
    res = tt.solve(_t(c), _t(a), _t(b), lay_t, param(tt), polish=True)
    assert float(res.cri_pri) <= 1e-9
    assert float(res.cri_dual) <= 1e-9
    np.testing.assert_allclose(res.x.numpy(), [2.0, 2.0], atol=1e-6)
    _close_to(res, res_j.x, res_j.y)


def test_polish_structured_operator():
    # any LinOp is densified under the size guard (chunked solves polish
    # too); an oversize operator raises before any densification
    c, g, h, spec = _bench_lp(n=64, seed=6)
    lay_j, lay_t = _lays(spec)

    def param(mod):
        return mod.SolverParam(max_iter=300_000, eps_acc=1e-3,
                               check_period=10)

    ell_j = jt.BlockedEllOp.from_dense(g, block=(32, 32))
    res_j = jt.solve(jnp.asarray(c), ell_j, jnp.asarray(h), lay_j,
                     param(jt), polish=True)
    ell = tt.BlockedEllOp.from_dense(g, block=(32, 32), device="cpu")
    res = tt.solve(_t(c), ell, _t(h), lay_t, param(tt), polish=True)
    assert float(res.cri_pri) <= 1e-9
    assert float(res.cri_dual) <= 1e-9
    _close_to(res, res_j.x, res_j.y)
    chunked = tt.solve(_t(c), ell, _t(h), lay_t, param(tt), polish=True,
                       chunk_iters=500)
    assert float(chunked.cri_pri) <= 1e-9
    _close_to(chunked, res_j.x, res_j.y)
    from totsu_tpu_torch.solver.polish import polish as _polish
    big = tt.ZeroOp(m=80_000, n=80_000, device="cpu")
    fake = types.SimpleNamespace(x=torch.zeros(80_000),
                                 y=torch.zeros(80_000))
    with pytest.raises(ValueError, match="MAX_DENSE_ENTRIES"):
        _polish(fake, np.zeros(80_000), big, np.zeros(80_000),
                tt.ConeLayout([tt.rpos(80_000)]))


@pytest.mark.parametrize("k", [1, 2, 3, 8, 48])
def test_pack_helpers_are_the_reference_loops(k):
    # the port's pack helpers use index arrays where the JAX package
    # loops entry by entry: the same arithmetic, bit for bit
    from totsu_tpu.solver import polish as jpol
    from totsu_tpu_torch.solver import polish as tpol
    rng = np.random.default_rng(k)
    v = rng.normal(size=k * (k + 1) // 2)
    m = rng.normal(size=(k, k))
    np.testing.assert_array_equal(tpol._unpack_np(v, k),
                                  jpol._unpack_np(v, k))
    np.testing.assert_array_equal(tpol._pack_np(m), jpol._pack_np(m))
