"""The port's utilities against the JAX package's: ``check_operator`` on
the port's operators, and the port's own copy of the contour extraction
(numpy only), which must give the JAX package's segments exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu_torch as tt
from totsu_tpu.solver.operator import CustomOp as JCustomOp
from totsu_tpu.utils import check_operator as jcheck_operator
from totsu_tpu.utils import contour as jcontour
from totsu_tpu_torch.utils import (check_operator, contour_segments,
                                   contour_series, chain_segments)


def _operators(a):
    at = torch.from_numpy(a)
    m, n = a.shape
    return {
        "dense": tt.DenseOp(at),
        "custom autograd": tt.CustomOp(params=at, m=m, n=n,
                                       matvec_fn=lambda p, x: p @ x),
        "stack": tt.VStackOp((tt.DenseOp(at), tt.DiagOp(torch.ones(
            n, dtype=at.dtype)))),
        "blocked ell": tt.BlockedEllOp.from_dense(
            np.pad(a, ((0, 1), (0, 3))), block=(4, 4), device="cpu"),
        "sparse": tt.SparseOp.from_dense(a, device="cpu"),
    }


@pytest.mark.parametrize("name", ["dense", "custom autograd", "stack",
                                  "blocked ell", "sparse"])
def test_check_operator_accepts_consistent_operators(name):
    a = np.random.default_rng(0).normal(size=(7, 5))
    check_operator(_operators(a)[name])


def test_check_operator_catches_a_wrong_adjoint():
    # tests/test_solver.py's case in both packages: a doubled adjoint fails
    a = np.random.default_rng(0).normal(size=(7, 5))
    jcheck_operator(JCustomOp(params=jnp.asarray(a), m=7, n=5,
                              matvec_fn=lambda p, x: p @ x))
    check_operator(tt.CustomOp(params=torch.from_numpy(a), m=7, n=5,
                               matvec_fn=lambda p, x: p @ x))
    with pytest.raises(AssertionError):
        jcheck_operator(JCustomOp(params=jnp.asarray(a), m=7, n=5,
                                  matvec_fn=lambda p, x: p @ x,
                                  rmatvec_fn=lambda p, y: 2.0 * (y @ p)))
    with pytest.raises(AssertionError, match="adjoint"):
        check_operator(tt.CustomOp(params=torch.from_numpy(a), m=7, n=5,
                                   matvec_fn=lambda p, x: p @ x,
                                   rmatvec_fn=lambda p, y: 2.0 * (y @ p)))


def test_check_operator_catches_wrong_abs_sums():
    a = np.random.default_rng(1).normal(size=(6, 4))
    at = torch.from_numpy(a)
    bad = tt.CustomOp(params=at, m=6, n=4, matvec_fn=lambda p, x: p @ x,
                      col_abssum_fn=lambda p: p.sum(0))
    with pytest.raises(AssertionError, match="col_abssum"):
        check_operator(bad)


def _same_segments(xs, ys, z, level=0.0):
    got = contour_segments(xs, ys, z, level)
    want = jcontour.contour_segments(xs, ys, z, level)
    np.testing.assert_array_equal(got, want)
    return got


def test_affine_level_set_is_exact():
    # bilinear edge interpolation is exact for affine f along grid edges
    xs = np.linspace(-1, 1, 9)
    ys = np.linspace(-1, 1, 7)
    gx, gy = np.meshgrid(xs, ys)
    z = 2.0 * gx - gy + 0.25
    segs = _same_segments(xs, ys, z)
    assert segs.shape[0] > 0
    pts = segs.reshape(-1, 2)
    np.testing.assert_allclose(2.0 * pts[:, 0] - pts[:, 1] + 0.25, 0.0,
                               atol=1e-12)


def test_circle_segments_lie_near_level_set_and_chain_closed():
    xs = np.linspace(-1.5, 1.5, 61)
    ys = np.linspace(-1.5, 1.5, 61)

    def f(x, y):
        return x * x + y * y

    segs = contour_series(xs, ys, f, level=1.0)
    np.testing.assert_array_equal(
        segs, jcontour.contour_series(xs, ys, f, level=1.0))
    assert segs.shape[0] > 40
    pts = segs.reshape(-1, 2)
    r = np.hypot(pts[:, 0], pts[:, 1])
    assert np.max(np.abs(r - 1.0)) < xs[1] - xs[0]
    lines = chain_segments(segs, tol=1e-9)
    want = jcontour.chain_segments(segs, tol=1e-9)
    assert len(lines) == len(want) == 1
    np.testing.assert_array_equal(lines[0], want[0])
    loop = lines[0]
    np.testing.assert_allclose(loop[0], loop[-1], atol=1e-9)
    ang = np.unwrap(np.arctan2(loop[:, 1], loop[:, 0]))
    assert abs(abs(ang[-1] - ang[0]) - 2 * np.pi) < 1e-6


def test_saddle_cells_emit_two_nonintersecting_segments():
    xs = np.array([0.0, 1.0])
    ys = np.array([0.0, 1.0])
    for z in (np.array([[1.0, -1.0], [-1.0, 1.0]]),    # code 9
              np.array([[-1.0, 1.0], [1.0, -1.0]])):   # code 6
        segs = _same_segments(xs, ys, z)
        assert segs.shape[0] == 2
        a, b = segs
        for p in a:
            for q in b:
                assert np.linalg.norm(p - q) > 0.1


def test_levels_and_empty_and_shape_validation():
    xs = np.linspace(0, 1, 5)
    ys = np.linspace(0, 1, 5)
    gx, gy = np.meshgrid(xs, ys)
    z = gx + gy
    assert _same_segments(xs, ys, z, level=5.0).shape == (0, 2, 2)
    assert chain_segments(contour_segments(xs, ys, z, level=5.0)) == []
    pts = _same_segments(xs, ys, z, level=1.0).reshape(-1, 2)
    np.testing.assert_allclose(pts[:, 0] + pts[:, 1], 1.0, atol=1e-12)
    with pytest.raises(ValueError, match="shape"):
        contour_segments(xs, ys[:-1], z)
