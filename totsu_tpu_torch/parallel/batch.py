"""Batched lockstep solves (port of ``totsu_tpu.parallel.batch``).

Lanes iterate in lockstep, each with its own status, until every lane
has stopped (``solver/batched.py``, which writes out what the JAX package
gets from ``jax.vmap(solve_jit)``). With a mesh, each rank solves the
lanes of its place on the ``batch`` axis (and, with ``row`` > 1, its row
block of their A); no collective runs across the batch axis until the
results are gathered at the end (``parallel/sharded.py`` states the
design).
"""

import dataclasses
from typing import Any, Optional, Tuple

import torch

from totsu_tpu_torch.parallel import _collectives as coll
from totsu_tpu_torch.parallel.mesh import axis_size
from totsu_tpu_torch.parallel.sharded import (RowShardedOp, RowSharding,
                                              even_split)
from totsu_tpu_torch.solver.batched import as_batched_op, solve_batch_jit
from totsu_tpu_torch.solver.cone import ConeLayout
from totsu_tpu_torch.solver.conic import SolveResult, _as_tensor
from totsu_tpu_torch.solver.operator import BatchedDenseOp, BatchedOp
from totsu_tpu_torch.solver.params import SolverParam, SolverStatus


def shard_batch(tree, mesh, axis: str = "batch"):
    """This rank's share of a batch-leading tree (tensors, arrays,
    :class:`BatchedDenseOp` s or :class:`BatchedOp` s in tuples or lists;
    None passes): rank i of ``axis`` takes lanes ``[i B/size, (i + 1)
    B/size)`` (a structured batch through ``BatchedOp.lanes``). A batch
    that does not split evenly raises ``ValueError``, as the JAX package's
    ``device_put`` does."""
    axis_size(mesh, axis)      # a mesh with this axis, else it raises
    i = mesh.get_local_rank(axis)

    def put(x):
        if x is None:
            return None
        if isinstance(x, (tuple, list)):
            return type(x)(put(t) for t in x)
        if isinstance(x, BatchedDenseOp):
            return BatchedDenseOp(put(x.a))
        lanes = x.batch if isinstance(x, BatchedOp) else x.shape[0]
        off = even_split(mesh, axis, lanes, "lanes")
        if isinstance(x, BatchedOp):
            return x.lanes(off[i], off[i + 1])
        return x[off[i]:off[i + 1]]

    return put(tree)


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

    * ``c``: (B, n), ``a``: (B, m, n) tensor, array,
      :class:`BatchedDenseOp` (an A expanded from one matrix is not
      copied) or :class:`BatchedOp` of structured lanes
      (``BatchedOp.stack``: pdhg, or the indirect engine under
      ``method='direct'``), ``b``: (B, m); the cone layout and ``param``
      are shared.
      Data that is not a tensor goes to ``device``, else to the CUDA card;
      c and b follow A.
    * ``warm_start``: (X (B, n) or None, Y (B, m) or None).
    * ``chunk_iters=N`` runs the batch as N-iteration calls stitched with
      exact per-lane checkpoints. Lanes that finish in an earlier chunk
      stay terminated with their checkpointed pair, so their ``iters`` and
      solution are those of the unchunked batch; calls continue while any
      lane is still EXCESS_ITER and the total is under
      ``param.max_iter``. On the megakernel (``kernel='mega'``) each
      chunk is one launch; its checkpoint carries no epoch, so a lane
      resumes with a check at its taken point (a stopped lane stops there
      at 0 iterations) and a fresh accel epoch, as in the JAX package.
    * ``kernel='mega'`` (or ``'auto'`` on the card) runs the lanes on the
      batched megakernel (:func:`solve_batch_jit`); with ``mesh``, each
      rank's lanes in one launch on its device; a batch whose rows are
      split over ``row`` raises, as the single solve does with a
      ``row_sharding``.
    * ``mesh`` (``parallel.make_mesh``): every rank passes the whole
      batch and solves its share of the lanes (:func:`shard_batch` over
      ``batch``); with ``row`` > 1 their A's rows are split over the
      ``row`` group (``parallel.sharded.RowShardedOp``; a dense batch
      only: a structured one raises ``ValueError`` there, as the JAX
      package shards a batch over ``batch`` alone). Each rank stops
      when its own lanes stop, so no collective runs across ``batch``
      inside the loop; x, y, the criteria, ``status`` and ``iters`` are
      then gathered over ``batch`` (two collectives) and are whole on
      every rank. ``state`` (with ``return_state``) holds this rank's
      lanes.

    Returns a :class:`SolveResult` whose ``status`` and ``iters`` are (B,)
    tensors and x, y and the criteria lane-leading tensors on A's device
    (:func:`solve_batch_jit`)."""
    if mesh is not None:
        return _solve_batch_mesh(c, a, b, cone, param, mesh, warm_start,
                                 chunk_iters, device)
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


def _solve_batch_mesh(c, a, b, cone, param, mesh, warm_start, chunk_iters,
                      device):
    """``solve_batch(mesh=)``: this rank's lanes (and rows), then the
    lanes gathered over ``batch``."""
    rows = axis_size(mesh, "row")
    a = as_batched_op(a, device)
    if not isinstance(a, (BatchedDenseOp, BatchedOp)):
        raise TypeError("solve_batch(mesh=) takes the whole batch's A, not "
                        "a sharded one")
    if rows > 1 and isinstance(a, BatchedOp):
        raise ValueError(
            "a structured batch shards over the mesh's batch axis only; "
            "row > 1 splits the rows of a dense batch")
    c = _as_tensor(c, a.device)
    b = _as_tensor(b, a.device)
    offsets = even_split(mesh, "batch", a.batch, "lanes")
    c, a, b, warm_start = shard_batch((c, a, b, warm_start), mesh)
    if rows > 1:
        sharding = RowSharding(mesh, "row",
                               even_split(mesh, "row", a.shape[0]))
        r0, r1 = sharding.rows
        a = RowShardedOp(BatchedDenseOp(a.a[:, r0:r1]), sharding)
    res = solve_batch(c, a, b, cone, param, warm_start=warm_start,
                      chunk_iters=chunk_iters)
    return _gather_lanes(res, mesh, offsets)


def _gather_lanes(res: SolveResult, mesh, offsets) -> SolveResult:
    """Every rank's lanes of ``res`` whole on every rank: one gather of
    x, y and the criteria, one of the statuses and iteration counts."""
    group = mesh.get_group("batch")
    start, total = offsets[mesh.get_local_rank("batch")], offsets[-1]
    n = res.x.shape[-1]
    m = res.y.shape[-1]
    crits = torch.stack([res.cri_pri, res.cri_dual, res.cri_gap,
                         res.cri_unbdd, res.cri_infeas], dim=-1)
    vals = coll.gather(torch.cat([res.x, res.y, crits], dim=-1), start,
                       total, group, dim=0)
    ints = coll.gather(torch.stack([res.status.to(torch.int64),
                                    res.iters.to(torch.int64)], dim=-1),
                       start, total, group, dim=0)
    return dataclasses.replace(
        res, x=vals[:, :n], y=vals[:, n:n + m],
        cri_pri=vals[:, n + m], cri_dual=vals[:, n + m + 1],
        cri_gap=vals[:, n + m + 2], cri_unbdd=vals[:, n + m + 3],
        cri_infeas=vals[:, n + m + 4],
        status=ints[:, 0].to(res.status.dtype), iters=ints[:, 1])
