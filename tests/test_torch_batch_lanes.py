"""Batched lockstep solves of the PyTorch port against the JAX package:
exp and PSD lanes, f32 statuses, chunking and an expanded A.

The companion of ``test_torch_batch.py`` (its helpers; the same rules):
in f64 every lane's status and iteration count equal the JAX package's
and x agrees within 1e-8; in f32 the statuses agree; a chunked batch
equals the whole batch bitwise on the CPU.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
from totsu_tpu.parallel import solve_batch as jsolve_batch
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.parallel import solve_batch
from totsu_tpu_torch.solver.operator import BatchedDenseOp
from test_torch_batch import (LP_CASES, _t, assert_lanes_match, lp_batch,
                              run_both)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))


def _gp_batch(scales):
    """The analytic GP of tests/test_problems.py with scaled
    coefficients, one per lane (3 exp blocks each)."""
    cs, as_, bs = [], [], []
    for s in scales:
        prob, _ = jt.problems.gp([[s], [1.0, 1.0]],
                                 [[[-1.0, -1.0]], [[1.0, 0.0], [0.0, 1.0]]])
        cs.append(np.asarray(prob.c))
        as_.append(np.asarray(prob.a.a))
        bs.append(np.asarray(prob.b))
    return np.stack(cs), np.stack(as_), np.stack(bs), prob.cone


@pytest.mark.parametrize("accel", ["", "halpern"])
def test_exp_lanes_match_the_jax_package(accel):
    c, a, b, lay = _gp_batch([1.0, 1.4, 2.0])
    rj, rt = run_both(c, a, b, lay, dict(max_iter=300_000, eps_acc=1e-7,
                                          check_period=10, accel=accel))
    assert_lanes_match(rj, rt)
    np.testing.assert_allclose(np.exp(rt.x[0, :2].numpy()), [0.5, 0.5],
                               atol=1e-4)


def _nearestcorr(method, lanes=4, k=5):
    import nearestcorr_batch_sdp as nc
    from totsu_tpu.ops import sympack
    covs = nc.make_noisy_covs(lanes, k)
    a, c, lay, _, sn = nc.build(k, jnp.float64)
    lay = jt.ConeLayout([jt.psd(k, method=method) if f.kind == "psd"
                         else f for f in lay.factors])
    b = np.stack([np.concatenate([
        [0.0], -np.asarray(sympack.pack(jnp.asarray(s), scaled=True)),
        np.zeros(sn), np.ones(k)]) for s in covs])
    return (np.broadcast_to(np.asarray(c), (lanes, c.shape[0])),
            np.broadcast_to(np.asarray(a), (lanes,) + a.shape), b, lay)


@pytest.mark.parametrize("method", ["jacobi", "eigh"])
def test_psd_lanes_match_the_jax_package(method):
    c, a, b, lay = _nearestcorr(method)
    rj, rt = run_both(c, a, b, lay, dict(max_iter=20_000, eps_acc=1e-4,
                                          check_period=25))
    assert_lanes_match(rj, rt)
    assert (rt.status == 1).all()


def test_expanded_a_is_not_copied():
    c, a, b, lay = _nearestcorr("eigh", lanes=3)
    shared = _t(a[0])
    op = BatchedDenseOp(shared.expand(3, -1, -1))
    assert op.a.stride(0) == 0 and op.a.data_ptr() == shared.data_ptr()
    res = solve_batch(_t(c), op, _t(b), interop.cone_from_reference(lay),
                      tt.SolverParam(max_iter=20_000, eps_acc=1e-4,
                                     check_period=25))
    ref = solve_batch(_t(c), _t(a), _t(b), interop.cone_from_reference(lay),
                      tt.SolverParam(max_iter=20_000, eps_acc=1e-4,
                                     check_period=25))
    assert torch.equal(res.x, ref.x) and torch.equal(res.iters, ref.iters)


@pytest.mark.parametrize("name", ["halpern", "direct_halpern", "plain"])
def test_f32_statuses_match_the_jax_package(name):
    c, a, b, m = lp_batch(seed=4)
    kw = dict(LP_CASES[name] if name != "plain" else LP_CASES["plain"])
    kw["eps_acc"] = 1e-4
    rj, rt = run_both(c, a, b, jt.ConeLayout([jt.rpos(m)]),
                      dict(max_iter=30_000, **kw), dtype=np.float32)
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    assert rt.x.dtype == torch.float32


def test_solve_batch_chunked_matches_unchunked():
    """Twin of tests/test_parallel.py's chunked batch: per-lane statuses,
    counts and x equal the whole batch's (bitwise here), lanes that
    finish early stay terminated, and max_iter caps the chunked batch
    exactly."""
    rng = np.random.default_rng(2)
    bsz, n = 4, 24
    cs, gs, hs = [], [], []
    for _ in range(bsz):
        g = rng.normal(size=(2 * n, n))
        h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
        gs.append(np.concatenate([g, np.eye(n), -np.eye(n)]))
        hs.append(np.concatenate([h, np.full(2 * n, 10.0)]))
        cs.append(rng.normal(size=n))
    c, g, h = _t(np.stack(cs)), _t(np.stack(gs)), _t(np.stack(hs))
    lay = tt.ConeLayout([tt.rpos(4 * n)])
    p = tt.SolverParam(max_iter=100_000, eps_acc=1e-6, check_period=20,
                       accel="halpern")
    full = solve_batch(c, g, h, lay, p)
    chunked = solve_batch(c, g, h, lay, p, chunk_iters=200)
    assert (full.status == 1).all() and (chunked.status == 1).all()
    assert int(full.iters.max()) > 200
    assert torch.equal(full.iters, chunked.iters)
    assert torch.equal(full.x, chunked.x)
    # the JAX package's counts
    rj = jsolve_batch(jnp.asarray(c.numpy()), jnp.asarray(g.numpy()),
                      jnp.asarray(h.numpy()), jt.ConeLayout([jt.rpos(4 * n)]),
                      jt.SolverParam(max_iter=100_000, eps_acc=1e-6,
                                     check_period=20, accel="halpern"),
                      chunk_iters=200)
    np.testing.assert_array_equal(chunked.iters.numpy(), np.asarray(rj.iters))
    p_cap = tt.SolverParam(max_iter=100, eps_acc=1e-12, check_period=20)
    capped = solve_batch(c, g, h, lay, p_cap, chunk_iters=40)
    assert (capped.iters == 100).all()
    assert (capped.status == int(tt.SolverStatus.EXCESS_ITER)).all()


@pytest.mark.parametrize("method,accel", [("pdhg", "restart"),
                                          ("direct", ""),
                                          ("direct", "halpern")])
def test_chunked_batch_is_the_whole_batch(method, accel):
    c, a, b, m = lp_batch(seed=5)
    lay = tt.ConeLayout([tt.rpos(m)])
    p = tt.SolverParam(max_iter=30_000, eps_acc=1e-5, check_period=10,
                       method=method, accel=accel)
    full = solve_batch(_t(c), _t(a), _t(b), lay, p)
    chunked = solve_batch(_t(c), _t(a), _t(b), lay, p, chunk_iters=30)
    assert torch.equal(full.iters, chunked.iters)
    assert torch.equal(full.status, chunked.status)
    assert torch.equal(full.x, chunked.x)


@pytest.mark.parametrize("lanes", [1, 32, 512])
def test_kernel_plans_take_every_lane(lanes):
    # a batch hands kernels B and J every lane's blocks of a factor at
    # once: 29c's growth portfolios (63 pow and 50 exp blocks a lane) and
    # 31's nearest-correlation SDPs (one (8, 8) block a lane) on an H100
    from totsu_tpu_torch.ops.kernels import cone_proj as cp
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj
    for kind, count in (("pow", 63), ("exp", 50)):
        pl = cp.plan(lanes * count, kind, torch.float32, 132)
        assert pl.grid * pl.threads >= lanes * count * cp.LANES
    for dtype in (torch.float32, torch.float64):
        pl = pj.plan(8, lanes, dtype, 232_448, 132)
        assert pl.count == lanes and pl.smem_bytes <= 232_448
