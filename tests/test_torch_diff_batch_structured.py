"""The batch-leading differentiable solver of the PyTorch port on a
structured operator, against the JAX package's ``jax.vmap`` of its
solver: ``make_differentiable_solver`` takes a ``BatchedOp`` (the
counterpart of vmapping over a stacked pytree) or one structured
operator shared by every lane (``in_axes=None``). The A cotangent lands
on each lane's BlockedEllOp tiles (``blocks`` and ``blocks_t``), summed
over the lanes for a shared operator; forward-mode tangents come the
same way. In f64 on the CPU, within 1e-6 relative of the JAX package.

Two lanes of ``tests/test_torch_diff_ell.py``'s banded LP (seeds 3 and
4), each A scaled by its own tile scale theta_i; d loss/d theta_i is
the tiles' cotangent against the tiles."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import totsu_tpu as jt
from totsu_tpu.diff import make_differentiable_solver as jmds
import totsu_tpu_torch as tt
from totsu_tpu_torch.diff import make_differentiable_solver as tmds
from test_torch_diff_ell import _band_lp
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

PJ = jt.SolverParam(max_iter=200_000, eps_acc=1e-9, method="direct",
                    accel="halpern", check_period=10)
PT = tt.SolverParam(max_iter=200_000, eps_acc=1e-9, method="direct",
                    accel="halpern", check_period=10)
RTOL, ATOL = 1e-6, 1e-9
N, BM = 8, 4
THETA = (1.0, 0.8)


def _lanes():
    lps = [_band_lp(s) for s in (3, 4)]
    return tuple(np.stack([lp[j] for lp in lps]) for j in range(3))


def _jax_ells(a):
    return [jt.BlockedEllOp.from_dense(ai, block=(BM, BM)) for ai in a]


def _scaled_j(theta, ell):
    return jt.BlockedEllOp(theta * ell.blocks, ell.cols, theta * ell.blocks_t,
                           ell.cols_t, m=3 * N, n=N, bm=BM, bn=BM)


def _jax_grads(c, a, h, in_axes=0):
    """jax.vmap(jax.grad) of each lane's loss sum(x^2) in its theta."""
    sj = jmds(jt.ConeLayout([jt.rpos(3 * N)]), PJ)

    def loss(theta, ell, ci, hi):
        return jnp.sum(sj(ci, _scaled_j(theta, ell), hi)[0] ** 2)

    ells = _jax_ells(a)
    if in_axes is None:
        ell = ells[0]
    else:
        ell = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ells)
    thetas = jnp.asarray(THETA) if in_axes is not None else 1.0
    return np.asarray(jax.vmap(jax.grad(loss), in_axes=(
        0 if in_axes is not None else None, in_axes, 0, 0))(
        thetas, ell, jnp.asarray(c), jnp.asarray(h)))


def _port_batch(a, thetas):
    """The port's BatchedOp of the lanes' tiles scaled by theta_i, its
    floating tensors (blocks, blocks_t) leaves that take gradients."""
    ells = [tt.BlockedEllOp.from_dense(ai, block=(BM, BM), device="cpu")
            for ai in a]
    batch = tt.BatchedOp.stack(ells)
    blocks, cols, blocks_t, cols_t = batch.leaves
    th = torch.tensor(thetas, dtype=torch.float64).view(-1, 1, 1, 1, 1)
    blk = (th * blocks).requires_grad_(True)
    blk_t = (th * blocks_t).requires_grad_(True)
    return batch.with_leaves([blk, cols, blk_t, cols_t]), blocks, blocks_t


def test_batch_gradient_on_the_tiles_is_jax_vmap_grad():
    """Each lane's tile cotangent, reduced against its tiles, is
    jax.vmap(jax.grad) of its loss in theta_i; the cotangents keep the
    lanes apart (a (B, ...) cotangent for (B, ...) tiles)."""
    c, a, h = _lanes()
    st = tmds(tt.ConeLayout([tt.rpos(3 * N)]), PT)
    op, blocks, blocks_t = _port_batch(a, THETA)
    x, _ = st(torch.tensor(c), op, torch.tensor(h))
    g_blk, g_blk_t = torch.autograd.grad(torch.sum(x ** 2),
                                         [op.leaves[0], op.leaves[2]])
    assert g_blk.shape == blocks.shape
    got = ((g_blk * blocks).sum(dim=(1, 2, 3, 4))
           + (g_blk_t * blocks_t).sum(dim=(1, 2, 3, 4))).numpy()
    np.testing.assert_allclose(got, _jax_grads(c, a, h), rtol=RTOL,
                               atol=ATOL)
    assert len(st.stats["lsqr_steps"]) == 2


def test_shared_operator_cotangent_is_the_lanes_sum():
    """One BlockedEllOp shared by both lanes (c and b lane-leading): its
    tiles' cotangent is the sum of the lanes', as jax.vmap with the
    operator's in_axes None and the lanes' gradients summed."""
    c, a, h = _lanes()
    st = tmds(tt.ConeLayout([tt.rpos(3 * N)]), PT)
    ell = tt.BlockedEllOp.from_dense(a[0], block=(BM, BM), device="cpu")
    blk = ell.blocks.clone().requires_grad_(True)
    blk_t = ell.blocks_t.clone().requires_grad_(True)
    op = tt.BlockedEllOp(blk, ell.cols, blk_t, ell.cols_t, m=3 * N, n=N,
                         bm=BM, bn=BM)
    x, _ = st(torch.tensor(c), op, torch.tensor(h))
    g_blk, g_blk_t = torch.autograd.grad(torch.sum(x ** 2), [blk, blk_t])
    assert g_blk.shape == blk.shape
    got = float((g_blk * ell.blocks).sum() + (g_blk_t * ell.blocks_t).sum())
    a_shared = np.broadcast_to(a[0], a.shape)
    want = _jax_grads(c, a_shared, h, in_axes=None).sum()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_batch_tangent_is_jax_vmap_jvp():
    """mode='jvp': each lane's tangent of x along d theta_i = 1 (the tiles'
    tangent the lane's own tiles), against jax.vmap(jax.jvp)."""
    c, a, h = _lanes()
    sf = tmds(tt.ConeLayout([tt.rpos(3 * N)]), PT, mode="jvp")
    op, blocks, blocks_t = _port_batch(a, THETA)
    blk, cols, blk_t, cols_t = op.leaves

    def fwd(b1, b2):
        return sf(torch.tensor(c), op.with_leaves([b1, cols, b2, cols_t]),
                  torch.tensor(h))[0]

    _, dx = torch.func.jvp(fwd, (blk.detach(), blk_t.detach()),
                           (blocks, blocks_t))
    sj = jmds(jt.ConeLayout([jt.rpos(3 * N)]), PJ, mode="jvp")

    def lane(theta, ell, ci, hi):
        return jax.jvp(lambda t: sj(ci, _scaled_j(t, ell), hi)[0], (theta,),
                       (jnp.ones_like(theta),))[1]

    ells = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *_jax_ells(a))
    want = jax.vmap(lane)(jnp.asarray(THETA), ells, jnp.asarray(c),
                          jnp.asarray(h))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
