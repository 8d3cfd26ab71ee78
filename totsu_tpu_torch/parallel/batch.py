"""Batched lockstep solves (port of ``totsu_tpu.parallel.batch``).

Lanes iterate in lockstep, each with its own status, until every lane
has stopped (``solver/batched.py``, which writes out what the JAX package
gets from ``jax.vmap(solve_jit)``). Sharding the batch over devices is
ROADMAP item 14b: ``mesh`` and :func:`shard_batch` raise until then.
"""

import dataclasses
from typing import Any, Optional, Tuple

import torch

from totsu_tpu_torch.solver.batched import as_batched_op, solve_batch_jit
from totsu_tpu_torch.solver.cone import ConeLayout
from totsu_tpu_torch.solver.conic import SolveResult, _not_ported
from totsu_tpu_torch.solver.params import SolverParam, SolverStatus


def shard_batch(tree, mesh, axis: str = "batch"):
    """Placing a batch over a device mesh is ROADMAP item 14b."""
    raise _not_ported("shard_batch", "14b")


def solve_batch(
    c,
    a,
    b,
    cone: ConeLayout,
    param: SolverParam = SolverParam(),
    mesh=None,
    warm_start: Optional[Tuple[Any, Any]] = None,
    chunk_iters: Optional[int] = None,
    *,
    device=None,
) -> SolveResult:
    """Solve a batch of conic programs in lockstep.

    * ``c``: (B, n), ``a``: (B, m, n) tensor, array or
      :class:`BatchedDenseOp` (an A expanded from one matrix is not
      copied), ``b``: (B, m); the cone layout and ``param`` are shared.
      Data that is not a tensor goes to ``device``, else to the CUDA card;
      c and b follow A.
    * ``warm_start``: (X (B, n) or None, Y (B, m) or None).
    * ``chunk_iters=N`` runs the batch as N-iteration calls stitched with
      exact per-lane checkpoints. Lanes that finish in an earlier chunk
      stay terminated with their checkpointed pair, so their ``iters`` and
      solution are those of the unchunked batch; calls continue while any
      lane is still EXCESS_ITER and the total is under
      ``param.max_iter``.
    * ``mesh`` (sharding the batch over devices) is ROADMAP item 14b.

    Returns a :class:`SolveResult` whose ``status`` and ``iters`` are (B,)
    tensors and x, y and the criteria lane-leading tensors on A's device
    (:func:`solve_batch_jit`)."""
    if mesh is not None:
        raise _not_ported("solve_batch(mesh=...)", "14b")
    if chunk_iters is not None:
        return _solve_batch_chunked(c, a, b, cone, param, warm_start,
                                    int(chunk_iters), device)
    return solve_batch_jit(c, a, b, cone, param, warm_start=warm_start,
                           device=device)


def _solve_batch_chunked(c, a, b, cone, param, warm_start, chunk_iters,
                         device):
    """Chunk-dispatched lockstep batch (see :func:`solve_batch`)."""
    if chunk_iters <= 0:
        raise ValueError(f"chunk_iters must be positive, got {chunk_iters}")
    a = as_batched_op(a, device)
    cap = param.bounded_max_iter
    p_chunk = dataclasses.replace(param, max_iter=min(chunk_iters, cap),
                                  return_state=True)
    res = solve_batch_jit(c, a, b, cone, p_chunk, warm_start=warm_start)
    total = int(res.state.k.max())
    while bool((res.status == SolverStatus.EXCESS_ITER).any()) \
            and total < cap:
        p_i = dataclasses.replace(p_chunk,
                                  max_iter=min(chunk_iters, cap - total))
        res = solve_batch_jit(c, a, b, cone, p_i, resume_state=res.state)
        total = int(res.state.k.max())
    # each lane's total is the global clock its checkpoint carries
    return dataclasses.replace(
        res, iters=res.state.k,
        state=res.state if param.return_state else None)
