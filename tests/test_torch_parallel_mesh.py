"""Row- and batch-sharded solves of the PyTorch port against the JAX
package: twins of the eight mesh tests of ``tests/test_parallel.py``.

The JAX package runs them on 8 virtual CPU devices of one process, and
its partitioner inserts the collectives. The port runs one process per
rank over gloo (``torch_dist.py`` spawns the worlds, the ranks run
``torch_dist_worker.py``), on meshes of 4 ranks where the JAX tests take
8: row 4, batch 4 and 2 x 2 (m = 48, the batches of 8 and 4 lanes and the
blocked-ELL LP's 24 x 8 tile grid split evenly over them). Each test
takes the JAX test's own instance, in f64, and computes the JAX package's
result and the port's unsharded one in this process.

* Sharded against unsharded: the iteration counts equal the JAX
  package's and the port's unsharded solve's; dense x within 1e-8 (the
  partial sums of A^T v are added in another order); blocked-ELL x
  bitwise equal to the port's unsharded solve (each rank computes whole
  rows and columns: nothing is re-associated; the JAX test allows
  1e-10); every x within 1e-8 of the JAX package's.
* The collective contracts, the twins of the HLO tests, read from the
  port's counts (``parallel/_collectives.py``): a dense ``dual_matvec``
  makes one m-gather and one n-sum, an update two of each and nothing
  else, a whole solve exactly one pair per ``dual_matvec`` and one pair
  for the preconditioner; a blocked-ELL solve moves only (m,) and (n,)
  vectors; a batch-sharded solve makes no collective but the two
  gathers of its results.
* A row count that does not split over the mesh raises, in both
  packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
from totsu_tpu.parallel import make_mesh as jmake_mesh
from totsu_tpu.parallel import shard_dense_problem as jshard_dense
from totsu_tpu.parallel import solve_batch as jsolve_batch
import totsu_tpu_torch as tt
from totsu_tpu_torch.parallel import _collectives as coll
import test_parallel as jtests
import torch_dist
import torch_dist_worker as w
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

DENSE = ["dense_row4", "dense_counts", "ragged_rows",
         "shard_batch_placement"]
BATCH = ["batch4", "batch4_counts", "mesh2x2"]
ELL = ["ell_row4", "ell_counts"]


# three worlds of 4 ranks, each spawned once: 17-35 s each on an idle
# machine, so that each stays far inside torch_dist's limit under load
@pytest.fixture(scope="module")
def dense_world():
    return torch_dist.run_world("torch_dist_worker", 4, DENSE)


@pytest.fixture(scope="module")
def batch_world():
    return torch_dist.run_world("torch_dist_worker", 4, BATCH)


@pytest.fixture(scope="module")
def ell_world():
    return torch_dist.run_world("torch_dist_worker", 4, ELL)


def _same_on_every_rank(results, key="x"):
    """The ranks hold the whole result, bitwise the same."""
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0]


def _lay(m):
    return jt.ConeLayout([jt.rpos(m)])


def test_worker_instances_are_the_jax_tests():
    for seed, kw in ((0, dict(n=16, m=48)), (1, dict(n=8, m=24, batch=(8,))),
                     (2, dict(n=8, m=24, batch=(4,)))):
        for ours, theirs in zip(
                w.random_lp(np.random.default_rng(seed), **kw),
                jtests.random_lp(np.random.default_rng(seed), **kw)):
            np.testing.assert_array_equal(ours, theirs)
    c, a, h = w.blocked_ell_grid_lp()
    jc, jell, jh, _ = jtests._blocked_ell_grid_lp()
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(
        a, np.asarray(jell.to_dense()))


def test_sharded_solve_matches_unsharded(dense_world):
    c, g, h = w.random_lp(np.random.default_rng(0), n=16, m=48)
    ref = jt.solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
                       _lay(48), jt.SolverParam(**w.DENSE_PARAM))
    assert int(ref.status) == jt.SolverStatus.CONVERGED
    whole = w._dense_problem(c, g, h).solve_jit(
        tt.SolverParam(**w.DENSE_PARAM))
    assert whole.iters == int(ref.iters)
    results = dense_world.result("dense_row4")
    assert [r["rows"] for r in results] == [12] * 4
    sh = _same_on_every_rank(results)
    assert sh["status"] == tt.SolverStatus.CONVERGED
    assert sh["iters"] == whole.iters
    np.testing.assert_allclose(sh["x"], whole.x.numpy(), atol=1e-8, rtol=0)
    np.testing.assert_allclose(sh["x"], np.asarray(ref.x), atol=1e-8,
                               rtol=0)


def test_sharded_solve_collective_counts(dense_world):
    """The twin of the HLO count: one m-gather and one n-sum per
    dual_matvec, two of each per update and no other collective, and in a
    whole solve exactly 2 per iteration, 1 per check and 1 for the
    preconditioner of each."""
    m, n = 48, 16
    for r in dense_world.result("dense_counts"):
        assert r["dual_matvec"] == {("gather", m): 1, ("sum", n): 1}
        assert r["update"] == {("gather", m): 2, ("sum", n): 2}
        k = r["iters"]
        per_kind = 2 * k + k // w.COUNT_PARAM["check_period"] + 1
        assert r["solve"] == {("gather", m): per_kind, ("sum", n): per_kind}


def test_batch_sharded_solve(batch_world):
    c, g, h = w.random_lp(np.random.default_rng(1), n=8, m=24, batch=(8,))
    ref = jsolve_batch(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
                       _lay(24), jt.SolverParam(**w.DENSE_PARAM))
    sh = _same_on_every_rank(batch_world.result("batch4"))
    assert (sh["status"] == tt.SolverStatus.CONVERGED).all()
    np.testing.assert_array_equal(sh["iters"], np.asarray(ref.iters))
    # every instance against its solo solve (the JAX test's lanes)
    for i in range(0, 8, 3):
        solo = jt.solve_jit(jnp.asarray(c[i]), jnp.asarray(g[i]),
                            jnp.asarray(h[i]), _lay(24),
                            jt.SolverParam(**w.DENSE_PARAM))
        np.testing.assert_allclose(sh["x"][i], np.asarray(solo.x),
                                   atol=1e-6)
    np.testing.assert_allclose(sh["x"], np.asarray(ref.x), atol=1e-8,
                               rtol=0)


def test_batch_sharded_zero_collectives(batch_world):
    """Each rank iterates its own lanes: the only collectives of a
    batch-sharded solve are the two gathers of its results, after the
    loop (the JAX package allows one all-reduce, its joint stop
    predicate)."""
    lanes, n, m = 8, 8, 24
    for r in batch_world.result("batch4_counts"):
        assert r["counts"] == {("gather", lanes * (n + m + 5)): 1,
                               ("gather", lanes * 2): 1}
        assert (r["iters"] == w.COUNT_PARAM["max_iter"]).all()


def test_2d_mesh_batch_and_row(batch_world):
    c, g, h = w.random_lp(np.random.default_rng(2), n=8, m=24, batch=(4,))
    ref = jsolve_batch(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
                       _lay(24), jt.SolverParam(**w.DENSE_PARAM))
    results = batch_world.result("mesh2x2")
    sh = _same_on_every_rank(results)
    assert (sh["status"] == tt.SolverStatus.CONVERGED).all()
    np.testing.assert_array_equal(sh["iters"], np.asarray(ref.iters))
    solo = jt.solve_jit(jnp.asarray(c[0]), jnp.asarray(g[0]),
                        jnp.asarray(h[0]), _lay(24),
                        jt.SolverParam(**w.DENSE_PARAM))
    np.testing.assert_allclose(sh["x"][0], np.asarray(solo.x), atol=1e-6)
    np.testing.assert_allclose(sh["x"], np.asarray(ref.x), atol=1e-8,
                               rtol=0)
    # inside the loop only the row groups' gathers of (2 lanes x 24) and
    # sums of (2 lanes x 8); the batch group's two gathers at the end
    for r in results:
        counts = dict(r["counts"])
        assert counts.pop(("gather", 4 * (8 + 24 + 5))) == 1
        assert counts.pop(("gather", 4 * 2)) == 1
        assert set(counts) == {("gather", 2 * 24), ("sum", 2 * 8)}
        assert counts[("gather", 48)] == counts[("sum", 16)]


def test_shard_batch_placement(dense_world):
    parts = dense_world.result("shard_batch_placement")
    assert [p.shape for p in parts] == [(4, 5)] * 4
    np.testing.assert_array_equal(np.concatenate(parts),
                                  np.arange(80.0).reshape(16, 5))


def test_sharded_blocked_ell_matches_unsharded(ell_world):
    jc, jell, jh, jlay = jtests._blocked_ell_grid_lp()
    ref = jt.solve_jit(jnp.asarray(jc), jell, jnp.asarray(jh), jlay,
                       jt.SolverParam(**w.ELL_PARAM))
    assert int(ref.status) == jt.SolverStatus.CONVERGED
    whole = w.ell_problem().solve_jit(tt.SolverParam(**w.ELL_PARAM))
    assert whole.iters == int(ref.iters)
    results = ell_world.result("ell_row4")
    # 24 tile rows of A and 8 of A^T over 4 ranks
    assert [r["tiles"][0] for r in results] == [6] * 4
    sh = _same_on_every_rank(results)
    assert sh["status"] == tt.SolverStatus.CONVERGED
    assert sh["iters"] == whole.iters
    np.testing.assert_array_equal(sh["x"], whole.x.numpy())
    np.testing.assert_allclose(sh["x"], np.asarray(ref.x), atol=1e-8,
                               rtol=0)


def test_sharded_blocked_ell_collective_contract(ell_world):
    """Tile data never moves: every collective is a gather of an (m,) or
    (n,) vector (the JAX test: no all-gather above m elements)."""
    m, n = 384, 128
    for r in ell_world.result("ell_counts"):
        assert set(r["counts"]) == {("gather", m), ("gather", n)}
        assert r["tile_elems"] > m
        assert r["iters"] == w.COUNT_PARAM["max_iter"]


def test_ragged_rows_raise_as_in_jax(dense_world):
    """m = 50 over a row axis of 4: the JAX package's device_put raises
    (it does not pad), and so does the port's split."""
    g = np.random.default_rng(0).normal(size=(50, 8))
    jprob = jt.ConicProblem(jnp.zeros(8), jt.DenseOp(jnp.asarray(g)),
                            jnp.ones(50), _lay(50))
    with pytest.raises(ValueError, match="divisible"):
        jshard_dense(jprob, jmake_mesh(batch=1, row=4,
                                       devices=jax.devices("cpu")[:4]))
    for msg in dense_world.result("ragged_rows"):
        assert msg is not None and "do not split evenly" in msg


def test_single_device_paths_make_no_collective():
    """With no mesh and no row_sharding nothing needs torch.distributed
    and no collective runs."""
    coll.reset()
    c, g, h = w.random_lp(np.random.default_rng(0), n=16, m=48)
    w._dense_problem(c, g, h).solve_jit(tt.SolverParam(max_iter=100))
    cb, gb, hb = w.random_lp(np.random.default_rng(1), n=8, m=24,
                             batch=(2,))
    tt.solve_batch(w._t(cb), w._t(gb), w._t(hb), tt.ConeLayout(
        [tt.rpos(24)]), tt.SolverParam(max_iter=100))
    assert not torch.distributed.is_initialized()
    assert not coll.counts
