"""Consensus ADMM of the PyTorch port: twins of the four mesh-free tests
of ``tests/test_admm.py``, on the CPU in f64 (``device="cpu"``).

The split problem must match the joint solve (the port's and the JAX
package's), and the port's z must follow the JAX package's
``consensus_admm`` on the same agents: both run the same rounds of the
same lockstep subsolves, so z agrees to roundoff (1e-8) and the round
counts are equal. The two ``mesh=`` tests are in
``test_torch_admm_mesh.py``; a ``mesh`` that is not a DeviceMesh raises.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import totsu_tpu as jt
from totsu_tpu.parallel.admm import consensus_admm as jconsensus_admm
import totsu_tpu_torch as tt
from totsu_tpu_torch.parallel.admm import consensus_admm
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

CPU = "cpu"


def split_box_lp(n=6, n_agents=3, seed=0):
    """Joint problem: min c.x s.t. -1 <= x <= 1 plus random inactive rows,
    split row-wise into agents, cost split evenly."""
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


def test_consensus_matches_joint_lp():
    c, g_all, h_all, c_batch, a_batch, b_batch, rows_per = split_box_lp()
    res = consensus_admm(c_batch, a_batch, b_batch,
                         tt.ConeLayout([tt.rpos(rows_per)]), rho=1.0,
                         max_outer=300, tol=1e-5, device=CPU)
    assert res.converged, (res.pri_res, res.dual_res)
    assert np.all(res.subproblem_statuses == tt.SolverStatus.CONVERGED)
    joint = tt.solve(c, g_all, h_all, tt.ConeLayout([tt.rpos(len(h_all))]),
                     tt.SolverParam(max_iter=100_000), device=CPU)
    np.testing.assert_allclose(res.z, joint.x.numpy(), atol=1e-3)
    ref = jconsensus_admm(jnp.asarray(c_batch), jnp.asarray(a_batch),
                          jnp.asarray(b_batch),
                          jt.ConeLayout([jt.rpos(rows_per)]), rho=1.0,
                          max_outer=300, tol=1e-5)
    assert res.outer_iters == ref.outer_iters
    np.testing.assert_allclose(res.z, ref.z, atol=1e-8, rtol=0)


def test_admm_surfaces_unconverged_subsolves():
    c, g_all, h_all, c_batch, a_batch, b_batch, rows_per = split_box_lp()
    lay = tt.ConeLayout([tt.rpos(rows_per)])
    starved = tt.SolverParam(max_iter=3, eps_acc=1e-9, check_period=1)
    with pytest.warns(RuntimeWarning, match="did not converge"):
        res = consensus_admm(c_batch, a_batch, b_batch, lay, rho=1.0,
                             max_outer=3, tol=1e-5, param=starved,
                             device=CPU)
    assert res.rounds_with_unconverged_subsolves >= 1
    with pytest.raises(RuntimeError, match="did not converge"):
        consensus_admm(c_batch, a_batch, b_batch, lay, rho=1.0,
                       max_outer=3, tol=1e-5, param=starved,
                       strict_subsolves=True, device=CPU)


def test_admm_healthy_run_counts_zero():
    c, g_all, h_all, c_batch, a_batch, b_batch, rows_per = split_box_lp()
    res = consensus_admm(c_batch, a_batch, b_batch,
                         tt.ConeLayout([tt.rpos(rows_per)]), rho=1.0,
                         max_outer=300, tol=1e-5, strict_subsolves=True,
                         device=CPU)
    assert res.converged
    assert res.rounds_with_unconverged_subsolves == 0


def test_admm_rounds_per_sync_matches_per_round():
    c, g_all, h_all, c_batch, a_batch, b_batch, rows_per = split_box_lp()
    lay = tt.ConeLayout([tt.rpos(rows_per)])
    param = tt.SolverParam(max_iter=20_000, eps_acc=1e-6, check_period=10)
    r1 = consensus_admm(c_batch, a_batch, b_batch, lay, rho=1.0,
                        max_outer=8, tol=0.0, param=param,
                        adapt_rho=False, rounds_per_sync=1, device=CPU)
    r8 = consensus_admm(c_batch, a_batch, b_batch, lay, rho=1.0,
                        max_outer=8, tol=0.0, param=param,
                        adapt_rho=False, rounds_per_sync=8, device=CPU)
    np.testing.assert_allclose(r8.z, r1.z, rtol=1e-10, atol=1e-12)
    assert r8.outer_iters == r1.outer_iters == 8
    np.testing.assert_allclose(r8.pri_res, r1.pri_res, rtol=1e-8)
    ref = jconsensus_admm(jnp.asarray(c_batch), jnp.asarray(a_batch),
                          jnp.asarray(b_batch),
                          jt.ConeLayout([jt.rpos(rows_per)]), rho=1.0,
                          max_outer=8, tol=0.0,
                          param=jt.SolverParam(max_iter=20_000, eps_acc=1e-6,
                                               check_period=10),
                          adapt_rho=False, rounds_per_sync=8)
    np.testing.assert_allclose(r8.z, ref.z, atol=1e-8, rtol=0)


def test_admm_mesh_raises_naming_its_item():
    c, g_all, h_all, c_batch, a_batch, b_batch, rows_per = split_box_lp()
    with pytest.raises(TypeError, match="DeviceMesh"):
        consensus_admm(c_batch, a_batch, b_batch,
                       tt.ConeLayout([tt.rpos(rows_per)]), mesh=object(),
                       device=CPU)
