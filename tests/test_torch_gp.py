"""The GP reduction and the exp/pow solve path of the port against the JAX
package.

``gp()`` in both packages takes the same inputs; the conic data must be
the same (f64, exactly: both assemble it in numpy). The solves run in f64
through the host loop, whose exp and pow projections are the plain
PyTorch cores on the CPU; they follow the JAX engine term by term, so the
status and the iteration count agree exactly and x to roundoff (1e-8).
The two examples' instances are built by the JAX package's example code
and handed to the port as numpy data.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.problems.gp import gp as jgp
from totsu_tpu_torch import interop

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

# tests/test_problems.py's GP instances
GPS = {
    # min 1/(xy) s.t. x + y <= 1  ->  x = y = 1/2, f* = 4
    "analytic": dict(term_c=[[1.0], [1.0, 1.0]],
                     term_a=[[[-1.0, -1.0]], [[1.0, 0.0], [0.0, 1.0]]]),
    # two posynomial constraints and the monomial equality z = 2y
    "monomial_equality": dict(
        term_c=[[1.0], [0.2, 0.4], [0.125]],
        term_a=[[[-1.0, -1.0, -1.0]],
                [[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]],
                [[1.0, 1.0, 0.0]]],
        eq_c=[0.5], eq_a=[[0.0, -1.0, 1.0]]),
}


def _layout_spec(layout):
    return [(f.kind, f.dim, f.count, f.alpha) for f in layout.factors]


@pytest.mark.parametrize("name", list(GPS))
def test_gp_builds_the_jax_conic_data(name):
    pj, mj = jgp(**GPS[name])
    pt, mt = tt.problems.gp(**GPS[name], device="cpu")
    assert mt == mj
    assert pt.c.dtype == pt.b.dtype == pt.a.a.dtype == torch.float64
    for got, want in ((pt.c, pj.c), (pt.a.a, pj.a.a), (pt.b, pj.b)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _layout_spec(pt.cone) == _layout_spec(pj.cone)


def test_gp_dtype_option():
    pt, _ = tt.problems.gp(**GPS["analytic"], device="cpu",
                           dtype=torch.float32)
    assert pt.c.dtype == pt.b.dtype == pt.a.a.dtype == torch.float32


@pytest.mark.parametrize("name", list(GPS))
def test_gp_solve_matches_jax(name):
    # the JAX tests' settings (eps_acc 1e-7)
    param = dict(max_iter=300_000, eps_acc=1e-7)
    pj, meta = jgp(**GPS[name])
    pt, _ = tt.problems.gp(**GPS[name], device="cpu")
    rj = pj.solve(jt.SolverParam(**param))
    rt = pt.solve(tt.SolverParam(**param))
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    x = np.exp(rt.x.numpy()[:meta["n"]])
    if name == "analytic":
        np.testing.assert_allclose(x, [0.5, 0.5], atol=1e-3)
        assert abs(float(np.exp(rt.x.numpy()[meta["t"]])) - 4.0) < 1e-2
    else:
        np.testing.assert_allclose(x, [2.58199, 0.64550, 1.29099],
                                   rtol=2e-3)


@pytest.mark.parametrize("kwargs", [
    dict(term_c=[[-1.0]], term_a=[[[1.0]]]),
    dict(term_c=[[1.0]], term_a=[[[-1.0, -1.0]]], eq_c=[0.5, 2.0],
         eq_a=[[0.0, 1.0]]),
    dict(term_c=[[1.0], [1.0]], term_a=[[[-1.0, -1.0]], [[1.0, 0.0, 5.0]]]),
    dict(term_c=[[1.0]], term_a=[[[-1.0, -1.0]]], eq_c=[0.5],
         eq_a=[[0.0, 1.0, 2.0]]),
    dict(term_c=[[1.0], [1.0]], term_a=[[[-1.0]]]),
    dict(term_c=[[1.0, 2.0]], term_a=[[[-1.0]]]),
    dict(term_c=[[1.0]], term_a=[[[-1.0]]], eq_c=[-0.5], eq_a=[[1.0]]),
], ids=["nonpositive_coefficient", "eq_count", "exponent_columns",
        "eq_row_shape", "posynomial_count", "monomial_rows",
        "nonpositive_eq_coefficient"])
def test_gp_validation_errors(kwargs):
    # both packages refuse the same malformed inputs
    with pytest.raises(ValueError):
        jgp(**kwargs)
    with pytest.raises(ValueError):
        tt.problems.gp(**kwargs, device="cpu")


def _both(c, a, b, lay, **kw):
    rj = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay,
                      jt.SolverParam(**kw))
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu")
    rt = tt.solve_jit(ct, at, bt, interop.cone_from_reference(lay),
                      interop.param_from_reference(jt.SolverParam(**kw)))
    return rj, rt


def test_logreg_expcone_matches_jax():
    # examples/logreg_expcone.py at m = 24, n = 6: R+(36) and 48 exp blocks
    import logreg_expcone
    m, n, lam = 24, 6, 0.1
    rng = np.random.default_rng(3)
    w_true = np.concatenate([rng.normal(size=n // 2) * 2.0,
                             np.zeros(n - n // 2)])
    x = rng.normal(size=(m, n))
    y = np.where(x @ w_true + 0.3 * rng.normal(size=m) > 0, 1.0, -1.0)
    c, a, b, lay = logreg_expcone.build(x, y, lam)
    rj, rt = _both(c, a, b, lay, max_iter=100_000, eps_acc=1e-4)
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("kw", [
    dict(eps_acc=1e-4),
    dict(eps_acc=1e-4, accel="halpern", normalize=True, equil_iters=10),
], ids=["plain", "halpern_normalize_equil"])
def test_growthport_powexp_matches_jax(kw):
    # examples/growthport_powexp.py at n = 6, S = 4: zero(1), R+(7), 3
    # pow(1/2) blocks and 6 exp blocks
    import growthport_powexp
    rng = np.random.default_rng(0)
    returns = 1.0 + 0.3 * rng.standard_normal((4, 6)) ** 2 \
        - 0.1 * rng.random((4, 6))
    c, a, b, lay, root = growthport_powexp.build_problem(returns, -1.2)
    rj, rt = _both(c, a, b, lay, max_iter=100_000, **kw)
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    alloc = rt.x.numpy()[:6]
    assert abs(alloc.sum() - 1.0) < 1e-3 and (alloc > -1e-3).all()
