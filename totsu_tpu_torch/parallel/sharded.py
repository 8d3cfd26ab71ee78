"""Row-sharded operators (port of ``totsu_tpu.parallel.sharded``).

The design of the port's distribution, stated once:

* **One process per device, SPMD.** The JAX package is single-controller:
  one process places arrays over a mesh with ``NamedSharding`` and XLA's
  partitioner inserts every collective. The port runs one process per
  device in a ``torch.distributed`` process group (``multihost.init``);
  a mesh is a ``DeviceMesh`` with the named axes ``batch`` and ``row``
  (``mesh.py``), and every rank runs the same solve.
* **A is sharded, the vectors are replicated.** Each rank holds its row
  block of A; x, y, s, tau, kappa, b, c and every vector of the iterate
  stay whole on every rank. The cones, the criteria, Ruiz, the
  preconditioner and the loops of ``solver/conic.py`` then run unchanged
  on every rank, and every collective sits inside the operator. This
  departs from the JAX package, which keeps y, s and vm sharded: the
  O(m n) bytes and flops, the term that matters, are split all the same;
  no cone block has to align with a shard boundary; a PSD block larger
  than a shard needs nothing special. The solver core stays unchanged,
  as in the JAX package: the sharding is carried by the operator.
* **Collectives** (``_collectives.py``) are ``all_reduce``s, counted by
  kind and size: a sum, a max, or a gather (each rank's part written into
  zeros, summed: exact). Ranks agree bitwise on every replicated vector,
  so they take the same branches and make the same collectives.

:class:`RowShardedOp` over a dense (or lane-batched dense) row block:
``dual_matvec`` runs kernel 1 (``ops/kernels/dual_matvec.py``) on the
local rows, giving (A_loc u, A_loc^T v[rows]), then one m-gather and one
n-sum; ``matvec`` one m-gather, ``rmatvec`` one n-sum, the column
reductions a sum or a max, the row reductions a gather; ``diag_scale``
and ``astype`` are local, ``to_dense`` gathers A (what polish and diff
read from the JAX package's global array).

:class:`ShardedEllOp` splits a blocked-ELL operator's tiles by tile rows
of A (``blocks``/``cols``: A x computes this rank's rows) and by tile rows
of A^T (``blocks_t``/``cols_t``: A^T y computes this rank's columns).
Each product is local, then one vector gather; no tile data moves and no
partial sum is reduced, so a sharded ELL solve equals the unsharded one
bitwise (f64 on the CPU; f32 on the H100, ``chip_smoke.py`` phase 34b).

A row count that does not split evenly over the mesh axis raises
``ValueError``, as the JAX package's ``device_put`` does (checked on the
CPU: m = 50 over 4 devices raises, it does not pad).
"""

import dataclasses
from typing import Any, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from totsu_tpu_torch.parallel import _collectives as coll
from totsu_tpu_torch.parallel.mesh import axis_size
from totsu_tpu_torch.problems.base import ConicProblem
from totsu_tpu_torch.solver.operator import (BatchedDenseOp, BlockedEllOp,
                                            DenseOp, LinOp, _set, as_dtype)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """How a problem's constraint rows are split: over ``axis`` of
    ``mesh``, rank i of the axis holding rows ``offsets[i]`` to
    ``offsets[i + 1]``. ``ConicProblem.row_sharding`` and the sharded
    operators carry it; a solve checks that both agree."""
    mesh: DeviceMesh
    axis: str
    offsets: Tuple[int, ...]

    @property
    def group(self):
        return self.mesh.get_group(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.get_local_rank(self.axis)

    @property
    def rows(self) -> Tuple[int, int]:
        """This rank's rows, [start, stop)."""
        i = self.index
        return self.offsets[i], self.offsets[i + 1]


def even_split(mesh: DeviceMesh, axis: str, total: int,
               what: str = "rows") -> Tuple[int, ...]:
    """Offsets splitting ``total`` evenly over ``axis``; raises
    ``ValueError`` when it does not divide, as the JAX package's
    ``device_put`` does."""
    size = axis_size(mesh, axis)
    if total % size:
        raise ValueError(f"{total} {what} do not split evenly over the "
                         f"{size} ranks of mesh axis {axis!r}")
    step = total // size
    return tuple(i * step for i in range(size + 1))


@dataclasses.dataclass(frozen=True)
class RowShardedOp(LinOp):
    """A's rows split over ``sharding``: ``local`` is this rank's row
    block, a :class:`DenseOp` (m_loc, n) or a :class:`BatchedDenseOp`
    (B, m_loc, n) whose lanes share the split; vectors are whole (n,) and
    (m,), or lane-leading (B, n) and (B, m). See the module docstring for
    the collectives of each method."""
    local: LinOp
    sharding: RowSharding
    device: Any = dataclasses.field(default=None, init=False)
    group: Any = dataclasses.field(default=None, init=False, repr=False,
                                   compare=False)
    start: int = dataclasses.field(default=0, init=False)
    stop: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        if not isinstance(self.local, (DenseOp, BatchedDenseOp)):
            raise TypeError(f"RowShardedOp shards a DenseOp or "
                            f"BatchedDenseOp, got {type(self.local).__name__}")
        start, stop = self.sharding.rows
        if self.local.shape[0] != stop - start:
            raise ValueError(f"the local block has {self.local.shape[0]} "
                             f"rows, the sharding gives this rank "
                             f"{stop - start}")
        _set(self, device=self.local.device, group=self.sharding.group,
             start=start, stop=stop)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def shape(self):
        return (self.sharding.offsets[-1], self.local.shape[1])

    @property
    def batch(self) -> int:
        return self.local.batch

    def lane(self, i: int) -> "RowShardedOp":
        return self._with(self.local.lane(i))

    def _with(self, local) -> "RowShardedOp":
        return RowShardedOp(local, self.sharding)

    def _gather(self, part, dim=-1):
        return coll.gather(part, self.start, self.shape[0], self.group, dim)

    def _mine(self, v):
        return v[..., self.start:self.stop]

    def matvec(self, x):
        return self._gather(self.local.matvec(x))

    def rmatvec(self, y):
        return coll.reduce_sum(self.local.rmatvec(self._mine(y)), self.group)

    def dual_matvec(self, u, v):
        p, q = self.local.dual_matvec(u, self._mine(v))
        return self._gather(p), coll.reduce_sum(q, self.group)

    def col_abssum(self):
        return coll.reduce_sum(self.local.col_abssum(), self.group)

    def col_sqsum(self):
        return coll.reduce_sum(self.local.col_sqsum(), self.group)

    def col_absmax(self):
        return coll.reduce_max(self.local.col_absmax(), self.group)

    def row_abssum(self):
        return self._gather(self.local.row_abssum())

    def row_absmax(self):
        return self._gather(self.local.row_absmax())

    def diag_scale(self, d, e):
        return self._with(self.local.diag_scale(self._mine(d), e))

    def astype(self, dtype):
        return self._with(self.local.astype(dtype))

    def to_dense(self):
        return self._gather(self.local.to_dense(), dim=-2)


@dataclasses.dataclass(frozen=True)
class ShardedEllOp(LinOp):
    """A blocked-ELL operator's tiles split over ``sharding`` (see the
    module docstring): ``blocks``/``cols`` are this rank's tile rows of A
    (rows ``sharding.rows``), ``blocks_t``/``cols_t`` its tile rows of A^T
    (columns ``col_offsets[i]`` to ``col_offsets[i + 1]``), in
    :class:`BlockedEllOp`'s layout; ``cols`` and ``cols_t`` keep their
    global tile indices. The tile grid is exact (m = nbr bm, n = nbc bn)."""
    blocks: torch.Tensor
    cols: torch.Tensor
    blocks_t: torch.Tensor
    cols_t: torch.Tensor
    m: int
    n: int
    bm: int
    bn: int
    sharding: RowSharding
    col_offsets: Tuple[int, ...]
    device: Any = dataclasses.field(default=None, init=False)
    group: Any = dataclasses.field(default=None, init=False, repr=False,
                                   compare=False)

    def __post_init__(self):
        _set(self, device=self.blocks.device, group=self.sharding.group)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def shape(self):
        return (self.m, self.n)

    def _row_part(self, part):
        """The whole (m,) vector from this rank's rows."""
        return coll.gather(part.reshape(-1), self.sharding.rows[0], self.m,
                           self.group)

    def _col_part(self, part):
        """The whole (n,) vector from this rank's columns."""
        return coll.gather(part.reshape(-1),
                           self.col_offsets[self.sharding.index], self.n,
                           self.group)

    def matvec(self, x):
        return self._row_part(BlockedEllOp._product(self.blocks, self.cols,
                                                    x, self.bn))

    def rmatvec(self, y):
        return self._col_part(BlockedEllOp._product(
            self.blocks_t, self.cols_t, y, self.bm))

    def col_abssum(self):
        return self._col_part(self.blocks_t.abs().sum(dim=(2, 3)))

    def row_abssum(self):
        return self._row_part(self.blocks.abs().sum(dim=(2, 3)))

    def row_absmax(self):
        return self._row_part(self.blocks.abs().amax(dim=(2, 3)))

    def col_absmax(self):
        return self._col_part(self.blocks_t.abs().amax(dim=(2, 3)))

    def col_sqsum(self):
        return self._col_part((self.blocks_t * self.blocks_t).sum(
            dim=(2, 3)))

    def diag_scale(self, d, e):
        """diag(d) A diag(e) on the local tiles, as
        :meth:`BlockedEllOp.diag_scale` (d and e are whole): no
        collective."""
        r0, r1 = self.sharding.rows
        i = self.sharding.index
        c0, c1 = self.col_offsets[i], self.col_offsets[i + 1]
        dt = d.view(-1, self.bm)
        et = e.view(-1, self.bn)

        def gather(t, cols):
            return t.index_select(0, cols.view(-1)).view(
                cols.shape[0], 1, cols.shape[1], t.shape[1])

        blocks = self.blocks * d[r0:r1].view(-1, self.bm)[:, :, None, None] \
            * gather(et, self.cols)
        blocks_t = self.blocks_t \
            * e[c0:c1].view(-1, self.bn)[:, :, None, None] \
            * gather(dt, self.cols_t)
        return dataclasses.replace(self, blocks=blocks, blocks_t=blocks_t)

    def astype(self, dtype):
        dtype = as_dtype(dtype)
        return dataclasses.replace(self, blocks=self.blocks.to(dtype),
                                   blocks_t=self.blocks_t.to(dtype))


def shard_dense_problem(prob: ConicProblem, mesh: DeviceMesh,
                        row_axis: str = "row") -> ConicProblem:
    """The problem with A's rows split over ``row_axis``: every rank passes
    the whole problem and keeps its row block of A (a contiguous copy);
    c and b stay whole. The result carries the :class:`RowSharding` that
    its solve checks."""
    if not isinstance(prob.a, DenseOp):
        raise TypeError("shard_dense_problem requires a DenseOp problem")
    sharding = RowSharding(mesh, row_axis,
                           even_split(mesh, row_axis, prob.a.shape[0]))
    r0, r1 = sharding.rows
    local = DenseOp(prob.a.a[r0:r1].contiguous())
    return ConicProblem(c=prob.c, a=RowShardedOp(local, sharding), b=prob.b,
                        cone=prob.cone, row_sharding=sharding)


def shard_blocked_ell_problem(prob: ConicProblem, mesh: DeviceMesh,
                              row_axis: str = "row") -> ConicProblem:
    """The problem with a blocked-ELL A's tiles split over ``row_axis`` (see
    :class:`ShardedEllOp`): each rank streams 1/size of the tile bytes in
    both directions, and a product moves one (m,) or (n,) vector.

    Requires m == nbr*bm and n == nbc*bn (no ragged tail) and tile-grid
    axes divisible by the mesh axis, as in the JAX package."""
    op = prob.a
    if not isinstance(op, BlockedEllOp):
        raise TypeError("shard_blocked_ell_problem requires a BlockedEllOp")
    nbr = op.blocks.shape[0]
    nbc = op.blocks_t.shape[0]
    ndev = axis_size(mesh, row_axis)
    if op.m != nbr * op.bm or op.n != nbc * op.bn:
        raise ValueError(
            f"shape ({op.m}, {op.n}) must fill the tile grid exactly "
            f"({nbr}x{op.bm}, {nbc}x{op.bn}) for aligned sharding")
    if nbr % ndev or nbc % ndev:
        raise ValueError(
            f"tile grid ({nbr}, {nbc}) not divisible by mesh axis {ndev}")
    sharding = RowSharding(mesh, row_axis,
                           even_split(mesh, row_axis, op.m))
    col_offsets = even_split(mesh, row_axis, op.n, "columns")
    i = sharding.index
    tr = slice(i * nbr // ndev, (i + 1) * nbr // ndev)
    tc = slice(i * nbc // ndev, (i + 1) * nbc // ndev)
    a = ShardedEllOp(op.blocks[tr].contiguous(), op.cols[tr].contiguous(),
                     op.blocks_t[tc].contiguous(),
                     op.cols_t[tc].contiguous(), m=op.m, n=op.n, bm=op.bm,
                     bn=op.bn, sharding=sharding, col_offsets=col_offsets)
    return ConicProblem(c=prob.c, a=a, b=prob.b, cone=prob.cone,
                        row_sharding=sharding)
