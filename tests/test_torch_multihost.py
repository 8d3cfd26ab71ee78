"""Two processes joined through the port's ``multihost.init``: the twin of
``tests/test_multihost.py``.

Two spawned ranks (``torch_dist.py`` with ``join=None``; the ranks run
``torch_dist_worker.multihost_batch``) call ``multihost.init`` with a
``tcp`` coordinator, the world size, their rank and the gloo backend,
check ``is_multihost()``, and run the batch-sharded lockstep solve of
``multihost_worker.py``'s 16 LPs on a (batch 2) mesh. Each rank's shard of
the result (and the whole, which every rank holds) must match a local
single-process solve of the whole batch: x to 1e-8, the statuses and the
iteration counts equal, and those equal the JAX package's batch in f64.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import totsu_tpu as jt
from totsu_tpu.parallel import solve_batch as jsolve_batch
import totsu_tpu_torch as tt
import torch_dist
import torch_dist_worker as w
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def pair():
    return torch_dist.run_world("torch_dist_worker", 2, ["multihost_batch"],
                                join=None)


def test_two_process_batch_solve_parity(pair):
    cb, gb, hb = w.multihost_batch_data()
    lay = tt.ConeLayout([tt.rpos(gb.shape[1])])
    local = tt.solve_batch(w._t(cb), w._t(gb), w._t(hb), lay,
                           tt.SolverParam(**w.MULTIHOST_PARAM), device="cpu")
    assert (local.status == tt.SolverStatus.CONVERGED).all()
    ref = jsolve_batch(jnp.asarray(cb), jnp.asarray(gb), jnp.asarray(hb),
                       jt.ConeLayout([jt.rpos(gb.shape[1])]),
                       jt.SolverParam(**w.MULTIHOST_PARAM))
    np.testing.assert_array_equal(local.iters.numpy(), np.asarray(ref.iters))
    for rank, r in enumerate(pair.result("multihost_batch")):
        assert r["multihost"]
        shard = slice(8 * rank, 8 * (rank + 1))
        for part in (shard, slice(None)):
            np.testing.assert_allclose(r["x"][part], local.x.numpy()[part],
                                       atol=1e-8, rtol=0)
            np.testing.assert_array_equal(r["status"][part],
                                          local.status.numpy()[part])
            np.testing.assert_array_equal(r["iters"][part],
                                          local.iters.numpy()[part])
        assert r["counts"] == {("gather", 16 * (12 + 48 + 5)): 1,
                               ("gather", 16 * 2): 1}
