"""Batched lockstep solves and consensus ADMM (port of
``totsu_tpu.parallel``).

The names of the JAX package's ``__all__`` are all here. The lockstep
batch (:func:`solve_batch`) and consensus ADMM (:func:`consensus_admm`)
run on one device; meshes, sharded problems and multi-host runs are
ROADMAP item 14b (explicit ``torch.distributed`` collectives where XLA's
partitioner inserts them): those names raise ``NotImplementedError``
when called.
"""

import types

from totsu_tpu_torch.parallel.batch import solve_batch, shard_batch
from totsu_tpu_torch.parallel.admm import consensus_admm, AdmmResult
from totsu_tpu_torch.solver.conic import _not_ported


def _pending(name: str):
    def pending(*args, **kwargs):
        raise _not_ported(name, "14b")
    pending.__name__ = name
    pending.__doc__ = f"``{name}`` is ROADMAP item 14b; it raises."
    return pending


make_mesh = _pending("make_mesh")
local_mesh = _pending("local_mesh")
shard_dense_problem = _pending("shard_dense_problem")
shard_blocked_ell_problem = _pending("shard_blocked_ell_problem")
multihost = types.SimpleNamespace(init=_pending("multihost.init"),
                                  is_multihost=_pending(
                                      "multihost.is_multihost"))

__all__ = [
    "make_mesh", "local_mesh", "solve_batch", "shard_batch",
    "shard_dense_problem", "shard_blocked_ell_problem", "consensus_admm",
    "AdmmResult", "multihost",
]
