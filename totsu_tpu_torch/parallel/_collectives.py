"""The collectives of the distribution layer, counted.

Every collective of ``totsu_tpu_torch.parallel`` is one
``torch.distributed.all_reduce`` made by :func:`all_reduce`, which adds
one to :data:`counts` under its kind and its element count. A collective
times out after the process group's timeout (``multihost.init`` gives
it :data:`TIMEOUT`): gloo raises in the waiting rank, NCCL's watchdog
ends the collective and its process, so a hung collective never stalls
the ranks for good. Under NCCL the call does not block the host (the
current stream waits on the collective).

A gather is an all_reduce too: each rank writes its part into a zero
buffer of the whole and the buffers are summed, which is exact (every
element is one rank's value plus zeros). It is the one collective that
NCCL, gloo on CPU tensors and gloo on CUDA tensors all take.

``counts`` is the port's twin of the JAX package's HLO tests, which count
the collectives XLA inserted: a test or ``chip_smoke.py`` clears it with
:func:`reset` before a path and reads it after.
"""

import collections
import datetime

import torch
import torch.distributed as dist

#: collectives since the last :func:`reset`, by (kind, elements): kind
#: "gather" (a part written into zeros, summed), "sum" or "max"
counts = collections.Counter()

#: the process group's timeout that ``multihost.init`` sets: a collective
#: waits for the slowest rank, and a batch-sharded solve's gather of its
#: results waits for the rank whose lanes run longest
TIMEOUT = datetime.timedelta(minutes=10)

_OPS = {"gather": dist.ReduceOp.SUM, "sum": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX}


def reset() -> None:
    counts.clear()


def all_reduce(t: torch.Tensor, kind: str, group) -> torch.Tensor:
    """``t`` reduced in place over ``group`` by the op of ``kind``, counted;
    returns ``t``."""
    dist.all_reduce(t, op=_OPS[kind], group=group)
    counts[(kind, t.numel())] += 1
    return t


def reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` (reduced in place)."""
    return all_reduce(t, "sum", group)


def reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of every rank's ``t`` (reduced in place)."""
    return all_reduce(t, "max", group)


def gather(part: torch.Tensor, offset: int, size: int, group,
           dim: int = -1) -> torch.Tensor:
    """The whole of a tensor whose rank-local ``part`` covers
    ``[offset, offset + part.shape[dim])`` of its ``size`` entries along
    ``dim``: every rank's part written into zeros and summed."""
    shape = list(part.shape)
    shape[dim] = size
    out = part.new_zeros(shape)
    out.narrow(dim, offset, part.shape[dim]).copy_(part)
    return all_reduce(out, "gather", group)
