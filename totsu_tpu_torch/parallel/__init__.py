"""Batched, sharded and distributed solves (port of
``totsu_tpu.parallel``).

The names of the JAX package's ``__all__``: the lockstep batch
(:func:`solve_batch`), consensus ADMM (:func:`consensus_admm`), meshes
(:func:`make_mesh`, :func:`local_mesh`), row-sharded problems
(:func:`shard_dense_problem`, :func:`shard_blocked_ell_problem`), the
batch split (:func:`shard_batch`) and the process-group bootstrap
(:mod:`multihost`). The JAX package places arrays over a mesh and lets
XLA insert the collectives; the port runs one process per device over
``torch.distributed`` and makes them itself (``sharded.py`` states the
design).
"""

from totsu_tpu_torch.parallel import multihost
from totsu_tpu_torch.parallel.mesh import make_mesh, local_mesh
from totsu_tpu_torch.parallel.batch import solve_batch, shard_batch
from totsu_tpu_torch.parallel.sharded import (shard_blocked_ell_problem,
                                              shard_dense_problem)
from totsu_tpu_torch.parallel.admm import consensus_admm, AdmmResult

__all__ = [
    "make_mesh", "local_mesh", "solve_batch", "shard_batch",
    "shard_dense_problem", "shard_blocked_ell_problem", "consensus_admm",
    "AdmmResult", "multihost",
]
