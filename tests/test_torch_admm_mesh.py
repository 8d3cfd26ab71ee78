"""Consensus ADMM of the PyTorch port over a mesh: twins of the two mesh
tests of ``tests/test_admm.py``.

The agents are sharded over the ``batch`` axis of a gloo world
(``torch_dist.py``; the ranks run ``torch_dist_worker.py``): 4 agents
over 4 ranks, and 3 agents over 3 ranks with 4 rounds per sync. Each run
must match the JAX package's unsharded ``consensus_admm`` on the same
agents, in f64: the same number of rounds and z to roundoff (the sum over
agents is an all_reduce of each rank's partial sum, added in another
order than ``mean``), and the sharded run must reach the joint LP's
solution as the JAX test asks. Every rank holds the whole result. Each
round makes one collective (the sum of the z-update), and each sync one
more (every agent's residual and status).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import totsu_tpu as jt
from totsu_tpu.parallel.admm import consensus_admm as jconsensus_admm
import test_admm as jtests
import torch_dist
import torch_dist_worker as w
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def world4():
    return torch_dist.run_world("torch_dist_worker", 4, ["admm_sharded4"])


@pytest.fixture(scope="module")
def world3():
    return torch_dist.run_world("torch_dist_worker", 3, ["admm_rps_mesh3"])


def _same_on_every_rank(results):
    for r in results[1:]:
        np.testing.assert_array_equal(r["z"], results[0]["z"])
        assert r["outer_iters"] == results[0]["outer_iters"]
    return results[0]


def _jax_run(data, **kw):
    _, _, _, c_batch, a_batch, b_batch, rows_per = data
    return jconsensus_admm(jnp.asarray(c_batch), jnp.asarray(a_batch),
                           jnp.asarray(b_batch),
                           jt.ConeLayout([jt.rpos(rows_per)]), rho=1.0,
                           **kw)


def test_worker_instances_are_the_jax_tests():
    for kw in ({}, dict(n=6, n_agents=4, seed=1)):
        for ours, theirs in zip(w.split_box_lp(**kw),
                                jtests.split_box_lp(**kw)):
            np.testing.assert_array_equal(ours, theirs)


def test_consensus_admm_sharded(world4):
    data = w.split_box_lp(n=6, n_agents=4, seed=1)
    c, g_all, h_all = data[:3]
    results = world4.result("admm_sharded4")
    res = _same_on_every_rank(results)
    assert res["converged"]
    assert (res["statuses"] == jt.SolverStatus.CONVERGED).all()
    assert res["x"].shape == (4, 6)
    joint = jt.solve(jnp.asarray(c), jnp.asarray(g_all), jnp.asarray(h_all),
                     jt.ConeLayout([jt.rpos(len(h_all))]),
                     jt.SolverParam(max_iter=100_000))
    np.testing.assert_allclose(res["z"], np.asarray(joint.x), atol=1e-3)
    ref = _jax_run(data, max_outer=300, tol=1e-5)
    assert res["outer_iters"] == ref.outer_iters
    np.testing.assert_allclose(res["z"], ref.z, atol=1e-8, rtol=0)
    np.testing.assert_allclose(res["x"], ref.x, atol=1e-8, rtol=0)
    k = res["outer_iters"]
    # one sum (n = 6) per round, one gather of every agent's residual and
    # status per sync (rounds_per_sync 1), one gather of x at the end
    assert res["counts"] == {("sum", 6): k, ("gather", 2 * 4): k,
                             ("gather", 4 * 6): 1}


def test_admm_mesh_with_rounds_per_sync(world3):
    data = w.split_box_lp()
    res = _same_on_every_rank(world3.result("admm_rps_mesh3"))
    ref = _jax_run(data, max_outer=8, tol=0.0,
                   param=jt.SolverParam(max_iter=20_000, eps_acc=1e-6,
                                        check_period=10),
                   adapt_rho=False, rounds_per_sync=1)
    assert res["outer_iters"] == ref.outer_iters == 8
    np.testing.assert_allclose(res["z"], ref.z, rtol=1e-8, atol=1e-10)
    # 8 rounds, 2 syncs of 4 rounds (each a gather of 4 x 2 x 3 values)
    assert res["counts"] == {("sum", 6): 8, ("gather", 4 * 2 * 3): 2,
                             ("gather", 3 * 6): 1}
