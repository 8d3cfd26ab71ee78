"""Scenarios that run on every rank of a spawned world (not a test module).

``torch_dist.run_world`` starts the ranks; each scenario ``f(rank, world,
port)`` runs on every rank of its world, on the CPU in f64, and returns
numpy data that the test module (``test_torch_parallel_mesh.py``,
``test_torch_admm_mesh.py``, ``test_torch_multihost.py``) holds against
the port's unsharded solves and the JAX package's, which it computes once
in its own process. This module imports torch, numpy and the port only:
the ranks never import JAX.

The instances are copies of the JAX tests' own (``random_lp`` and
``_blocked_ell_grid_lp`` of ``test_parallel.py``, ``split_box_lp`` of
``test_admm.py``, the batch of ``multihost_worker.py``); the test modules
check that the copies give the same arrays.
"""

import numpy as np
import torch

import totsu_tpu_torch as tt
from totsu_tpu_torch.parallel import (_collectives as coll, consensus_admm,
                                      make_mesh, multihost, shard_batch,
                                      shard_blocked_ell_problem,
                                      shard_dense_problem, solve_batch)
from totsu_tpu_torch.solver.conic import _make_update, _precond

CPU = "cpu"


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def random_lp(rng, n=24, m=48, batch=()):
    """test_parallel.random_lp: the box LP with random inactive rows."""
    c = rng.normal(size=batch + (n,)) + np.where(
        rng.random(batch + (n,)) > 0.5, 0.5, -0.5)
    eye = np.broadcast_to(np.eye(n), batch + (n, n))
    gr = rng.normal(size=batch + (m - 2 * n, n))
    hr = np.abs(gr).sum(-1) + 1.0
    g = np.concatenate([eye, -eye, gr], axis=-2)
    h = np.concatenate([np.ones(batch + (n,)), np.ones(batch + (n,)), hr],
                       axis=-1)
    return c, g, h


def blocked_ell_grid_lp(n=128):
    """test_parallel._blocked_ell_grid_lp's data: (c, dense A, h)."""
    rng = np.random.default_rng(21)
    band = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - 5), min(n, i + 5)
        band[i, lo:hi] = rng.normal(size=hi - lo)
    a = np.concatenate([band, np.eye(n), -np.eye(n)])
    h = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 5.0)])
    c = rng.normal(size=n)
    return c, a, h


def split_box_lp(n=6, n_agents=3, seed=0):
    """test_admm.split_box_lp."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=n) + np.where(rng.random(n) > 0.5, 0.5, -0.5)
    eye = np.eye(n)
    rows_per = 2 * n // n_agents
    g_all = np.concatenate([eye, -eye])
    h_all = np.ones(2 * n)
    perm = rng.permutation(2 * n)
    g_all, h_all = g_all[perm], h_all[perm]
    a_batch = np.stack([g_all[i * rows_per:(i + 1) * rows_per]
                        for i in range(n_agents)])
    b_batch = np.stack([h_all[i * rows_per:(i + 1) * rows_per]
                        for i in range(n_agents)])
    c_batch = np.tile(c / n_agents, (n_agents, 1))
    return c, g_all, h_all, c_batch, a_batch, b_batch, rows_per


def multihost_batch_data():
    """multihost_worker.py's batch: 16 bounded LPs, n = 12."""
    rng = np.random.default_rng(0)
    batch, n, m0 = 16, 12, 24
    g0 = rng.normal(size=(batch, m0, n))
    x0 = rng.normal(size=(batch, n))
    h0 = np.einsum("bmn,bn->bm", g0, x0) + rng.random((batch, m0)) + 0.1
    eye = np.broadcast_to(np.eye(n), (batch, n, n))
    gb = np.concatenate([g0, eye, -eye], axis=1)
    hb = np.concatenate([h0, np.full((batch, 2 * n), 10.0)], axis=1)
    cb = rng.normal(size=(batch, n))
    return cb, gb, hb


DENSE_PARAM = dict(max_iter=50_000, eps_acc=1e-6)
ELL_PARAM = dict(max_iter=200_000, eps_acc=1e-5, check_period=10,
                 accel="halpern", normalize=True)
COUNT_PARAM = dict(max_iter=200, eps_acc=1e-6, check_period=10)
MULTIHOST_PARAM = dict(max_iter=100_000, eps_acc=1e-4)


def _dense_problem(c, g, h):
    lay = tt.ConeLayout([tt.rpos(g.shape[0])])
    return tt.ConicProblem(_t(c), tt.DenseOp(_t(g)), _t(h), lay)


def _solved(res):
    return {"status": int(res.status), "iters": int(res.iters),
            "x": res.x.numpy()}


def dense_row4(rank, world, port):
    """The dense LP row-sharded over 4 ranks."""
    c, g, h = random_lp(np.random.default_rng(0), n=16, m=48)
    sharded = shard_dense_problem(_dense_problem(c, g, h),
                                  make_mesh(row=4, devices=CPU))
    return dict(_solved(sharded.solve_jit(tt.SolverParam(**DENSE_PARAM))),
                rows=sharded.a.local.shape[0])


def dense_counts(rank, world, port):
    """The collectives of one dual_matvec, one update and a whole
    row-sharded solve."""
    c, g, h = random_lp(np.random.default_rng(0), n=16, m=48)
    prob = shard_dense_problem(_dense_problem(c, g, h),
                               make_mesh(row=4, devices=CPU))
    a, n, m = prob.a, 16, 48
    rng = np.random.default_rng(5)
    coll.reset()
    p, q = a.dual_matvec(_t(rng.normal(size=n)), _t(rng.normal(size=m)))
    dm = dict(coll.counts)
    dp_tau, dp_sigma = _precond(a, prob.c, prob.b, prob.cone, 1e-12)
    update = _make_update(a, prob.c, prob.b, dp_tau, dp_sigma, prob.cone,
                          1.0)
    u = (_t(rng.normal(size=n)), _t(rng.normal(size=m)),
         _t(rng.normal(size=m)), _t(1.0))
    v = (_t(rng.normal(size=n)), _t(rng.normal(size=m)), _t(0.0))
    coll.reset()
    update(u, v)
    upd = dict(coll.counts)
    coll.reset()
    res = prob.solve_jit(tt.SolverParam(**COUNT_PARAM))
    return {"dual_matvec": dm, "update": upd, "solve": dict(coll.counts),
            "iters": int(res.iters)}


def _batch_result(res, counts):
    return {"status": res.status.numpy(), "iters": res.iters.numpy(),
            "x": res.x.numpy(), "counts": counts}


def batch4(rank, world, port):
    """test_batch_sharded_solve's batch on a batch-4 mesh."""
    c, g, h = random_lp(np.random.default_rng(1), n=8, m=24, batch=(8,))
    coll.reset()
    res = solve_batch(_t(c), _t(g), _t(h), tt.ConeLayout([tt.rpos(24)]),
                      tt.SolverParam(**DENSE_PARAM),
                      mesh=make_mesh(batch=4, devices=CPU))
    return _batch_result(res, dict(coll.counts))


def batch4_counts(rank, world, port):
    """test_batch_sharded_zero_collectives's batch: every collective of
    a batch-sharded solve."""
    c, g, h = random_lp(np.random.default_rng(3), n=8, m=24, batch=(8,))
    coll.reset()
    res = solve_batch(_t(c), _t(g), _t(h), tt.ConeLayout([tt.rpos(24)]),
                      tt.SolverParam(**COUNT_PARAM),
                      mesh=make_mesh(batch=4, devices=CPU))
    return {"counts": dict(coll.counts), "iters": res.iters.numpy()}


def mesh2x2(rank, world, port):
    """test_2d_mesh_batch_and_row's batch on a (batch 2, row 2) mesh."""
    c, g, h = random_lp(np.random.default_rng(2), n=8, m=24, batch=(4,))
    coll.reset()
    res = solve_batch(_t(c), _t(g), _t(h), tt.ConeLayout([tt.rpos(24)]),
                      tt.SolverParam(**DENSE_PARAM),
                      mesh=make_mesh(batch=2, row=2, devices=CPU))
    return _batch_result(res, dict(coll.counts))


def shard_batch_placement(rank, world, port):
    x = torch.arange(16 * 5, dtype=torch.float64).reshape(16, 5)
    (xs,) = shard_batch((x,), make_mesh(batch=4, devices=CPU))
    return xs.numpy()


def ell_problem():
    """The blocked-ELL LP as the port's ConicProblem on the CPU."""
    c, a, h = blocked_ell_grid_lp()
    ell = tt.BlockedEllOp.from_dense(a, block=(16, 16), device=CPU)
    return tt.ConicProblem(_t(c), ell, _t(h), tt.ConeLayout([tt.rpos(384)]))


def ell_row4(rank, world, port):
    """The blocked-ELL LP sharded over 4 ranks."""
    sharded = shard_blocked_ell_problem(ell_problem(),
                                        make_mesh(row=4, devices=CPU))
    return dict(_solved(sharded.solve_jit(tt.SolverParam(**ELL_PARAM))),
                tiles=tuple(sharded.a.blocks.shape))


def ell_counts(rank, world, port):
    """Every collective of a sharded blocked-ELL solve."""
    sharded = shard_blocked_ell_problem(ell_problem(),
                                        make_mesh(row=4, devices=CPU))
    coll.reset()
    res = sharded.solve_jit(tt.SolverParam(**dict(
        ELL_PARAM, max_iter=COUNT_PARAM["max_iter"])))
    return {"counts": dict(coll.counts), "iters": int(res.iters),
            "tile_elems": int(sharded.a.blocks.numel())}


def ragged_rows(rank, world, port):
    """m = 50 rows over a row axis of 4: the split raises."""
    g = np.random.default_rng(0).normal(size=(50, 8))
    prob = _dense_problem(np.zeros(8), g, np.ones(50))
    try:
        shard_dense_problem(prob, make_mesh(row=4, devices=CPU))
    except ValueError as e:
        return str(e)
    return None


def admm_sharded4(rank, world, port):
    """test_consensus_admm_sharded: 4 agents over a batch-4 mesh."""
    _, _, _, c_batch, a_batch, b_batch, rows_per = split_box_lp(
        n=6, n_agents=4, seed=1)
    coll.reset()
    res = consensus_admm(c_batch, a_batch, b_batch,
                         tt.ConeLayout([tt.rpos(rows_per)]), rho=1.0,
                         max_outer=300, tol=1e-5,
                         mesh=make_mesh(batch=4, devices=CPU), device=CPU)
    return {"z": res.z, "x": res.x, "converged": res.converged,
            "outer_iters": res.outer_iters,
            "statuses": res.subproblem_statuses,
            "counts": dict(coll.counts)}


def admm_rps_mesh3(rank, world, port):
    """test_admm_mesh_with_rounds_per_sync: 3 agents over a batch-3 mesh,
    4 rounds per sync, no rho adaptation."""
    _, _, _, c_batch, a_batch, b_batch, rows_per = split_box_lp()
    coll.reset()
    res = consensus_admm(
        c_batch, a_batch, b_batch, tt.ConeLayout([tt.rpos(rows_per)]),
        rho=1.0, max_outer=8, tol=0.0,
        param=tt.SolverParam(max_iter=20_000, eps_acc=1e-6,
                             check_period=10),
        adapt_rho=False, rounds_per_sync=4,
        mesh=make_mesh(batch=3, devices=CPU), device=CPU)
    return {"z": res.z, "outer_iters": res.outer_iters,
            "counts": dict(coll.counts)}


def multihost_batch(rank, world, port):
    """test_two_process_batch_solve_parity: the ranks join through
    ``multihost.init``; the batch-sharded solve against a local
    single-process solve of the whole batch."""
    multihost.init(coordinator_address=f"127.0.0.1:{port}",
                   num_processes=world, process_id=rank, backend="gloo")
    cb, gb, hb = multihost_batch_data()
    coll.reset()
    res = solve_batch(_t(cb), _t(gb), _t(hb),
                      tt.ConeLayout([tt.rpos(gb.shape[1])]),
                      tt.SolverParam(**MULTIHOST_PARAM),
                      mesh=make_mesh(batch=world, devices=CPU))
    return dict(_batch_result(res, dict(coll.counts)),
                multihost=multihost.is_multihost())
