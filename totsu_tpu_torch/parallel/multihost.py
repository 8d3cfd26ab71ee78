"""Process-group bootstrap (port of ``totsu_tpu.parallel.multihost``).

The JAX package wraps ``jax.distributed.initialize``; the port runs one
process per device and wraps ``torch.distributed.init_process_group``.
Typical use, one process per card (``torchrun --nproc-per-node 4``, or
each process started with its rank)::

    from totsu_tpu_torch.parallel import multihost, make_mesh, solve_batch
    multihost.init()                      # env:// under torchrun
    mesh = make_mesh(batch=2, row=2)
    res = solve_batch(c, a, b, cone, param, mesh=mesh)

Every rank passes the whole batch; each solves its own lanes, and the
result is whole on every rank.
"""

import os
from typing import Optional

import torch
import torch.distributed as dist

from totsu_tpu_torch.parallel import _collectives


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         backend: Optional[str] = None) -> None:
    """Join the process group (a no-op when one is initialized already).

    ``coordinator_address`` ("host:port", rank 0's), ``num_processes``
    and ``process_id`` give a ``tcp://`` rendezvous; left None, torchrun's
    ``env://`` variables are read. ``backend`` is NCCL unless the caller
    asks for another ("gloo": CPU tensors, or several ranks on one card,
    which NCCL refuses). Under NCCL the process takes the card
    ``LOCAL_RANK`` (else its rank) modulo the cards it sees. The group's
    collectives time out after ``_collectives.TIMEOUT``."""
    if dist.is_initialized():
        return
    backend = backend or "nccl"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=_collectives.TIMEOUT)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=_collectives.TIMEOUT)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def is_multihost() -> bool:
    """Whether this process is one of several in a process group."""
    return dist.is_initialized() and dist.get_world_size() > 1
