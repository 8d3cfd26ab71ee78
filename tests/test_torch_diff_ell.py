"""Implicit differentiation through a structured operator in the PyTorch
port against the JAX package: the twins of ``tests/test_diff.py``'s
``test_grad_through_blocked_ell_operator`` and
``test_jvp_through_blocked_ell_operator`` (the others are in
``test_torch_diff.py``), on the CPU in f64, at that file's tolerances:
within 1e-6 relative of the JAX package's derivative, and against
central differences at the JAX test's tolerances.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import chip_smoke as cs
import totsu_tpu as jt
from totsu_tpu.diff import make_differentiable_solver as jmds
import totsu_tpu_torch as tt
from totsu_tpu_torch.diff import make_differentiable_solver as tmds
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

PJ = jt.SolverParam(max_iter=200_000, eps_acc=1e-10, method="direct")
PT = tt.SolverParam(max_iter=200_000, eps_acc=1e-10, method="direct")
#: port vs JAX package
RTOL, ATOL = 1e-6, 1e-9


def _t(v, dtype=torch.float64, grad=False):
    return torch.tensor(np.asarray(v), dtype=dtype, requires_grad=grad)


def _band_lp(seed):
    rng = np.random.default_rng(seed)
    n = 8
    band = np.zeros((n, n))
    for i in range(n):
        band[i, max(0, i - 2):min(n, i + 2)] = rng.normal(
            size=min(n, i + 2) - max(0, i - 2))
    a = np.concatenate([band, np.eye(n), -np.eye(n)])
    h = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 2.0)])
    c = rng.normal(size=n)
    return c, a, h


def test_grad_through_blocked_ell_operator():
    """The A cotangent lands on a BlockedEllOp's tiles: against the dense
    A's cotangent on the stored tiles, against the JAX package's gradient
    of a scalar tile scale theta, and against finite differences of it.

    d loss/d theta comes from the tiles' cotangents (sum of cotangent x
    tile over ``blocks`` and ``blocks_t``), so one solve serves both
    checks: the port's indirect engine takes 21,159 DR iterations on this
    instance at eps_acc 1e-10 (as the JAX package does), about 17 s on
    one CPU core. The differences use the dense twin, the same map theta
    -> x(theta A)."""
    n, bm = 8, 4
    c, a, h = _band_lp(3)
    st = tmds(tt.ConeLayout([tt.rpos(3 * n)]), PT)
    sj = jmds(jt.ConeLayout([jt.rpos(3 * n)]), PJ)
    ell0 = tt.BlockedEllOp.from_dense(a, block=(bm, bm), device="cpu")
    ell0_j = jt.BlockedEllOp.from_dense(a, block=(bm, bm))

    def loss_ell_j(theta):
        op = jt.BlockedEllOp(theta * ell0_j.blocks, ell0_j.cols,
                             theta * ell0_j.blocks_t, ell0_j.cols_t,
                             m=3 * n, n=n, bm=bm, bn=bm)
        return jnp.sum(sj(jnp.asarray(c), op, jnp.asarray(h))[0] ** 2)

    def loss_dense(theta):
        return torch.sum(st(_t(c), theta * _t(a), _t(h))[0] ** 2)

    blk = ell0.blocks.clone().requires_grad_(True)
    blk_t = ell0.blocks_t.clone().requires_grad_(True)
    op = tt.BlockedEllOp(blk, ell0.cols, blk_t, ell0.cols_t, m=3 * n, n=n,
                         bm=bm, bn=bm)
    torch.sum(st(_t(c), op, _t(h))[0] ** 2).backward()
    a_t = _t(a, grad=True)
    torch.sum(st(_t(c), a_t, _t(h))[0] ** 2).backward()
    # the tiles' own cotangents against the dense A's on the stored
    # tiles: blocks' part plus blocks_t's part transposed
    tiles_g, tiles = cs.ell_tile_cotangent(tt, ell0, blk.grad, blk_t.grad,
                                           3 * n, n, bm)
    np.testing.assert_allclose(
        tiles_g.numpy(), torch.where(tiles, a_t.grad, 0.0).numpy(), rtol=0,
        atol=1e-8)
    g_ell = float((blk.grad * ell0.blocks).sum()
                  + (blk_t.grad * ell0.blocks_t).sum())
    g_dense = float((a_t.grad * _t(a)).sum())
    np.testing.assert_allclose(g_ell, g_dense, rtol=1e-6)
    np.testing.assert_allclose(g_ell, float(jax.grad(loss_ell_j)(1.0)),
                               rtol=RTOL)
    fd = (float(loss_dense(_t(1.0 + 1e-6)))
          - float(loss_dense(_t(1.0 - 1e-6)))) / 2e-6
    np.testing.assert_allclose(g_ell, fd, rtol=1e-4)


def test_jvp_through_blocked_ell_operator():
    """Forward mode with a structured operator: the tangent is the
    operator's own tile-space perturbation."""
    rng = np.random.default_rng(4)
    n, bm = 8, 4
    a = np.concatenate([rng.normal(size=(n, n)), np.eye(n), -np.eye(n)])
    h = np.concatenate([a[:n] @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 2.0)])
    c = rng.normal(size=n)
    st = tmds(tt.ConeLayout([tt.rpos(3 * n)]), PT, mode="jvp")
    sj = jmds(jt.ConeLayout([jt.rpos(3 * n)]), PJ, mode="jvp")
    ell0 = tt.BlockedEllOp.from_dense(a, block=(bm, bm), device="cpu")
    ell0_j = jt.BlockedEllOp.from_dense(a, block=(bm, bm))

    def at_theta(theta):
        return tt.BlockedEllOp(theta * ell0.blocks, ell0.cols,
                               theta * ell0.blocks_t, ell0.cols_t,
                               m=3 * n, n=n, bm=bm, bn=bm)

    def at_theta_j(theta):
        return jt.BlockedEllOp(theta * ell0_j.blocks, ell0_j.cols,
                               theta * ell0_j.blocks_t, ell0_j.cols_t,
                               m=3 * n, n=n, bm=bm, bn=bm)

    (_, _), (dx, _) = torch.func.jvp(
        lambda t: st(_t(c), at_theta(t), _t(h)), (_t(1.0),), (_t(1.0),))
    (_, _), (dxj, _) = jax.jvp(
        lambda t: sj(jnp.asarray(c), at_theta_j(t), jnp.asarray(h)),
        (1.0,), (1.0,))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dxj), rtol=RTOL,
                               atol=ATOL)
    # the tiles as the primals, as a user holding the tiles would write it
    (_, _), (dx2, _) = torch.func.jvp(
        lambda blk, blk_t: st(_t(c), tt.BlockedEllOp(
            blk, ell0.cols, blk_t, ell0.cols_t, m=3 * n, n=n, bm=bm,
            bn=bm), _t(h)),
        (ell0.blocks, ell0.blocks_t), (ell0.blocks, ell0.blocks_t))
    np.testing.assert_allclose(dx2.numpy(), dx.numpy(), rtol=1e-10,
                               atol=1e-12)
    eps = 1e-6
    xp, _ = st(_t(c), at_theta(_t(1.0 + eps)), _t(h))
    xm, _ = st(_t(c), at_theta(_t(1.0 - eps)), _t(h))
    fd = (xp.numpy() - xm.numpy()) / (2 * eps)
    np.testing.assert_allclose(dx.numpy(), fd, rtol=1e-3, atol=1e-7)
