"""The port's wrapper of the native C++ engine: twins of the nine tests of
``tests/test_native.py``.

``totsu_tpu_torch.native`` builds the unchanged ``native/totsu_ref.cpp``
into ``build/`` and takes the port's ``ConeLayout`` and ``SolverParam``.
On every instance its result must equal the JAX package's wrapper's
(the same source, built with the same flags), and the engine's iterate
path must match the port's f64 solve where it matches the JAX package's:
the golden LP's 160 iterations, equal iteration counts and x, y to 1e-9
(exp and pow: 1e-8). The projection oracle holds the port's plain exp and
pow projections (``cone_proj_plain``, which kernel B is held against on
the card) against the engine's bisection; a block past the tolerance
would be counted and named in the failure.
"""

import numpy as np
import pytest
import torch

import totsu_tpu as jt
from totsu_tpu.native import solve_native as jsolve_native
import totsu_tpu_torch as tt
from totsu_tpu_torch.native import (proj_exp_native, proj_pow_native,
                                    solve_native)
from totsu_tpu_torch.ops.kernels.cone_proj import cone_proj_plain
from totsu_tpu_torch.problems import qp
import test_native as jtests
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

PARAM = tt.SolverParam(max_iter=100_000)
CPU = "cpu"


def _layouts(factors):
    """The port's layout and the JAX package's for the same factors,
    given as (name, args) pairs."""
    return (tt.ConeLayout([getattr(tt, f)(*a) for f, a in factors]),
            jt.ConeLayout([getattr(jt, f)(*a) for f, a in factors]))


def _native(c, a, b, factors, param=PARAM):
    """The port's wrapper's result, held equal to the JAX package's."""
    lay, jlay = _layouts(factors)
    x, y, status, iters = solve_native(c, a, b, lay, _param(param))
    jx, jy, jstatus, jiters = jsolve_native(c, a, b, jlay, param)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert (int(status), iters) == (int(jstatus), jiters)
    return x, y, status, iters, lay


def _param(p):
    """The port's SolverParam with the JAX one's fields."""
    if isinstance(p, tt.SolverParam):
        return p
    return tt.SolverParam(max_iter=p.max_iter, eps_acc=p.eps_acc,
                          check_period=p.check_period)


def _solve(c, a, b, lay, param):
    return tt.solve(c, a, b, lay, _param(param), device=CPU)


PARAM_J = jt.SolverParam(max_iter=100_000)


def test_native_nostd_lp_golden():
    c = np.array([-1.0, 0.0])
    a = np.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = np.array([6.0, 6.0, 1.0])
    x, y, status, iters, _ = _native(c, a, b, [("rpos", (3,))], PARAM_J)
    assert status == tt.SolverStatus.CONVERGED
    assert iters == 160
    np.testing.assert_allclose(
        x, [1.9999994251590176, 2.0000004472430635], atol=1e-9)
    # tensors from any device are taken too
    xt, _, _, it_t = solve_native(torch.tensor(c), torch.tensor(a),
                                  torch.tensor(b),
                                  tt.ConeLayout([tt.rpos(3)]), PARAM)
    np.testing.assert_array_equal(xt, x)
    assert it_t == 160


def test_native_matches_port_iterates():
    rng = np.random.default_rng(3)
    n = 8
    eye = np.eye(n)
    g = np.concatenate([eye, -eye, rng.normal(size=(5, n))])
    h = np.concatenate([np.ones(2 * n), np.abs(g[2 * n:]).sum(1) + 1.0])
    c = rng.normal(size=n)
    xn, yn, status, iters_n, lay = _native(c, g, h, [("rpos", (len(h),))],
                                           PARAM_J)
    res = _solve(c, g, h, lay, PARAM)
    assert status == tt.SolverStatus.CONVERGED
    assert iters_n == res.iters
    np.testing.assert_allclose(xn, res.x.numpy(), atol=1e-9)
    np.testing.assert_allclose(yn, res.y.numpy(), atol=1e-9)


def test_native_soc():
    c = np.array([1.0, 1.0])
    a = np.array([[0.0, 0.0], [-1.0, 0.0], [0.0, -1.0]])
    b = np.array([np.sqrt(2.0), 0.0, 0.0])
    x, _, status, _, _ = _native(c, a, b, [("soc", (3,))], jt.SolverParam())
    assert status == tt.SolverStatus.CONVERGED
    np.testing.assert_allclose(x, [-1.0, -1.0], atol=1e-3)


def test_native_psd():
    c = np.array([1.0])
    a = np.array([[0.0], [-np.sqrt(2.0)], [-3.0]])
    b = np.array([1.0, 0.0, 10.0])
    x, _, status, iters, lay = _native(c, a, b, [("psd", (2,))], PARAM_J)
    assert status == tt.SolverStatus.CONVERGED
    np.testing.assert_allclose(x[0], -2.0, atol=1e-3)
    res = _solve(c, a, b, lay, PARAM)
    assert abs(iters - res.iters) <= 2


def test_native_infeasible_unbounded():
    _, _, status, _, _ = _native([1.0], [[1.0], [-1.0]], [-5.0, -10.0],
                                 [("rpos", (2,))], PARAM_J)
    assert status == tt.SolverStatus.INFEASIBLE
    _, _, status, _, _ = _native([1.0], [[1.0], [1.0]], [5.0, 10.0],
                                 [("rpos", (2,))], PARAM_J)
    assert status == tt.SolverStatus.UNBOUNDED


def test_native_rsoc_qp():
    prob = qp(np.eye(2), [1.0, 2.0], g=[[-0.5, -1.0 / 3.0]], h=[-1.0],
              device=CPU)
    x, _, status, _ = solve_native(prob.c, prob.a.a, prob.b, prob.cone,
                                   PARAM)
    assert status == tt.SolverStatus.CONVERGED
    np.testing.assert_allclose(x[:2], [2.0, 0.0], atol=1e-3)
    jprob = jt.problems.qp(np.eye(2), [1.0, 2.0], g=[[-0.5, -1.0 / 3.0]],
                           h=[-1.0])
    jx, _, _, _ = jsolve_native(np.asarray(jprob.c), np.asarray(jprob.a.a),
                                np.asarray(jprob.b), jprob.cone, PARAM_J)
    np.testing.assert_array_equal(x, jx)
    with pytest.raises(ValueError, match="not supported by the native"):
        solve_native(prob.c, prob.a.a, prob.b, tt.ConeLayout(
            [tt.custom(prob.cone.dim, lambda v: v)]), PARAM)


def _cone_case(factors, seed):
    """test_native._cone_instance's data, with the factors by name."""
    _, jlay = _layouts(factors)
    interiors = {"expc": np.array([0.0, 1.0, 2.0]),
                 "powc": np.array([2.0, 2.0, 1.0]), "rpos": np.ones(2)}
    c, a, b, _ = jtests._cone_instance(
        list(jlay.factors), [interiors[f] for f, _ in factors],
        seed=seed)
    return c, a, b, factors + [("rpos", (12,))]


@pytest.mark.parametrize("factors,seed", [
    ([("expc", (3,)), ("rpos", (2,))], 0),
    ([("powc", (0.3, 2)), ("powc", (0.85,)), ("rpos", (2,))], 1),
], ids=["exp", "pow"])
def test_native_exp_pow_match_port_iterates(factors, seed):
    """test_native_exp_matches_jax_iterates and
    test_native_pow_matches_jax_iterates: the engine's bisection and the
    port's fixed-trip hybrid take the same path."""
    c, a, b, factors = _cone_case(factors, seed)
    param = jt.SolverParam(max_iter=400_000, eps_acc=1e-7, check_period=20)
    xn, yn, status, iters_n, lay = _native(c, a, b, factors, param)
    res = _solve(c, a, b, lay, param)
    assert status == tt.SolverStatus.CONVERGED
    assert iters_n == res.iters
    np.testing.assert_allclose(xn, res.x.numpy(), atol=1e-8)
    np.testing.assert_allclose(yn, res.y.numpy(), atol=1e-8)


def test_native_exp_pow_projection_oracle():
    rng = np.random.default_rng(7)
    pts = np.concatenate([
        rng.normal(size=(200, 3)) * 3.0,
        rng.normal(size=(50, 3)) * 100.0,
        np.array([[0.0, 0.0, 0.0], [1.0, 0.0, -1.0], [-1.0, -1.0, 1.0],
                  [5.0, 1e-6, 0.1], [0.0, 1.0, 1.0], [0.3, 2.0, -4.0]]),
    ])
    scale = 1.0 + np.linalg.norm(pts, axis=1, keepdims=True)
    xb = torch.tensor(pts)
    for kind, alpha in (("exp", 0.0), ("pow", 0.27), ("pow", 0.5),
                        ("pow", 0.85)):
        ours = cone_proj_plain(xb, kind, alpha).numpy()
        nat = (proj_exp_native(pts) if kind == "exp"
               else proj_pow_native(xb, alpha))
        err = np.abs(ours - nat).max(axis=1) / scale[:, 0]
        stalled = np.nonzero(err > 5e-9)[0]
        assert stalled.size == 0, (
            f"{kind} alpha={alpha}: {stalled.size} blocks past 5e-9 of the "
            f"bisection: {[(int(i), pts[i].tolist()) for i in stalled]}")
