"""Whole-solve pdhg megakernel: wrapper of ``csrc/megakernel.cu`` and its
plain version.

Port of ``totsu_tpu/ops/pallas/megakernel.py`` (``solve_mega``,
``supported``, ``fits``) for the zero, R+, SOC, RSOC, exponential and
power cones with accel '' or 'halpern'. :func:`solve_mega` takes the host
loop's post-setup state (iterated and exact data, preconditioners, seed)
and returns its ``(u, v, k, status, crits)`` contract. On a CUDA tensor it
runs the whole loop in one kernel launch or raises; on a CPU tensor it
runs :func:`solve_mega_plain`, which is the port's own host loop
(``solver/conic.py``) called with the same inputs.

:func:`solve_mega_batch` is the same for a batch of lanes (the Pallas
kernel under ``jax.vmap``): every input has a leading lane dimension, A
may be one matrix expanded over the lanes, and one launch solves every
lane, each with its own loop and its own exit. A single solve is a batch
of one lane on the card. :func:`solve_mega_batch_plain` is its plain
version: :func:`solve_mega_plain` lane by lane.

The launch is planned here, by the pure functions :func:`plan` (one
lane: how many CTAs, which contiguous rows of A each owns, cut only
between cone blocks, whether each CTA holds its rows in shared memory,
the thread layout of the matvec pass and how the cross-CTA sums run)
and :func:`plan_batch` (how many CTAs each lane gets so that the launch
fits the card). The kernel takes the plan as it is.
"""

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from totsu_tpu_torch.ops.kernels import _build
from totsu_tpu_torch.solver.cone import (ConeLayout, ZERO, RPOS, SOC, RSOC,
                                         EXP, POW)

#: kernel launches since the last reset (CUDA only): ``launches`` by
#: :func:`solve_mega_cuda` (one solve), ``batch_launches`` by
#: :func:`solve_mega_batch_cuda` (a batch of lanes)
launches = 0
batch_launches = 0

#: Envelope of the kernel: the largest A (f32) it takes. The plan cuts A
#: into row slices, one per CTA, each held in its SM's shared memory
#: (232,448 bytes a block, about 30 MB over 132 SMs beside the vectors);
#: a slice that does not fit is read from L2 (50 MB) by its CTA on every
#: pass. 24 MiB keeps A within both. The value is the first design's;
#: what the kernel costs near and past it is not measured on the H100.
A_BUDGET_BYTES = 24 * 1024 * 1024

#: threads per CTA (the kernel's ``kThreads``)
THREADS = 512
_WARPS = THREADS // 32
#: column steps per thread per block of the matvec pass at most (the
#: kernel's ``kSteps``)
STEPS = 4
#: m-side scalars summed over the grid beside q (the kernel's ``kScal``)
SCALARS = 4
#: bytes of shared memory kept for the kernel's static arrays
STATIC_SMEM = 1024
#: a CTA's vectors go to shared memory up to this size, else to scratch
VEC_SMEM_BYTES = 96 * 1024

# The plan's cost model, per pdhg update (two matvec passes, two grid
# sums), in us, fitted to the times of the smoke's five megakernel cells
# over grid sizes and both sum modes on an NVIDIA H100 80GB HBM3 at 700 W
# (`mega_timing.py --sweep`; PERF.md). The pass is bound by instructions
# and latency, about 1.6 us per batch of 8 rows per row set at 4 column
# steps; a slice read from L2 instead of shared memory costs about a
# quarter more. A grid sum costs about 1 us (the partials' stores, one
# barrier, the CTA's syncs) plus about 0.45 us per round of L2 loads of
# the partials; the split mode's second barrier about 0.7 us.
BATCH_US = {1: 0.6, 2: 0.9, 4: 1.6}
STREAM_FACTOR = 1.25
SUM_US = 1.0
TRIP_US = 0.45
BARRIER_US = 0.7

#: keyword arguments every launch passes to :func:`plan` (``split``,
#: ``grid``, ``vec_smem``; through :func:`plan_batch` for a batch, where
#: ``grid`` is each lane's), to time or check a layout the plan would not
#: pick; empty by default
PLAN_OVERRIDES = {}

_KIND_ZERO, _KIND_RPOS, _KIND_BLOCK, _KIND_EXP, _KIND_POW = 0, 1, 2, 3, 4
#: kind column of the 3-block table (cone_exppow.cuh proj_block)
_TRI_KIND = {EXP: 0, POW: 1}


def supported(cone: ConeLayout) -> bool:
    """True when every cone factor has an in-kernel projection."""
    return all(f.kind in (ZERO, RPOS, SOC, RSOC, EXP, POW)
               for f in cone.factors)


def fits(m: int, n: int, cone: ConeLayout) -> bool:
    """True when A (f32) is within ``A_BUDGET_BYTES``, the envelope of A
    sliced over the SMs' shared memory (or read from L2 where a slice does
    not fit); the cone adds only an m-int kind table and a row of a few
    ints per block."""
    del cone
    return 4 * m * n <= A_BUDGET_BYTES


@functools.lru_cache(maxsize=64)
def cone_tables(cone: ConeLayout):
    """The kernel's cone tables: per-element kind (m,); SOC/RSOC blocks
    (nb, 3) = (start, dim, rotated), length-1 RSOC blocks being R+
    elements; exp/pow 3-blocks (nt, 2) = (start, 0 for exp or 1 for pow)
    and their power exponents (nt,) f32 (0 for exp)."""
    kind = np.empty(cone.dim, np.int32)
    blocks, tri, tri_alpha = [], [], []
    off = 0
    for f in cone.factors:
        if f.kind == ZERO:
            kind[off:off + f.total] = _KIND_ZERO
        elif f.kind == RPOS or (f.kind == RSOC and f.dim == 1):
            kind[off:off + f.total] = _KIND_RPOS
        elif f.kind in (SOC, RSOC):
            kind[off:off + f.total] = _KIND_BLOCK
            rot = int(f.kind == RSOC)
            blocks += [(off + i * f.dim, f.dim, rot) for i in range(f.count)]
        elif f.kind in (EXP, POW):
            kind[off:off + f.total] = _KIND_EXP if f.kind == EXP else _KIND_POW
            tri += [(off + 3 * i, _TRI_KIND[f.kind]) for i in range(f.count)]
            tri_alpha += [f.alpha] * f.count
        else:
            raise ValueError(f"megakernel: unsupported cone kind {f.kind!r}")
        off += f.total
    blocks = np.asarray(blocks, np.int32).reshape(-1, 3)
    tri = np.asarray(tri, np.int32).reshape(-1, 2)
    tri_alpha = np.asarray(tri_alpha, np.float32)
    for table in (kind, blocks, tri, tri_alpha):  # cached: shared
        table.setflags(write=False)
    return kind, blocks, tri, tri_alpha


def workspace_floats(n: int, rows: int) -> int:
    """Floats of one CTA's vectors (the kernel's ``workspace_floats``):
    eight n-vectors (x and vn of the iterate, its update and the Halpern
    anchor, two temporaries), eleven of the CTA's rows, the pass's table of
    per-warp row sums and its per-thread q sums."""
    return 8 * n + (11 + _WARPS) * rows + THREADS * STEPS


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the kernel.

    CTA ``g`` owns rows ``rows(g)`` of A, the SOC/RSOC blocks
    ``blk_off[g]:blk_off[g + 1]`` and the exp/pow 3-blocks
    ``tri_off[g]:tri_off[g + 1]`` of the cone tables, and holds its rows
    of A in shared memory when ``a_smem[g]``. Its matvec pass runs
    ``THREADS // col_threads`` row sets of ``col_threads`` threads.
    ``split``: the cross-CTA sums are cut by columns over the CTAs (two
    grid barriers per sum) instead of summed by every CTA (one barrier).
    """
    m: int
    n: int
    grid: int
    row_off: tuple
    blk_off: tuple
    tri_off: tuple
    a_smem: tuple
    threads: int
    col_threads: int
    vec_smem: bool
    split: bool
    ws_floats: int
    a_floats: int     # floats of A per CTA in shared memory (the largest)
    ld: int           # floats per row of the partials buffer
    smem_bytes: int   # dynamic shared memory per CTA
    update_us: float  # the cost model's time per pdhg update

    def rows(self, g: int) -> range:
        return range(self.row_off[g], self.row_off[g + 1])

    @property
    def rows_max(self) -> int:
        return max(b - a for a, b in zip(self.row_off, self.row_off[1:]))

    @property
    def a_smem_bytes(self) -> int:
        """Bytes of A held in shared memory over all CTAs."""
        return 4 * self.n * sum(len(self.rows(g)) for g in range(self.grid)
                                if self.a_smem[g])

    @property
    def partials_len(self) -> int:
        """Floats of the partials buffer: two slots of grid rows, and the
        split mode's row of sums."""
        return (2 * self.grid + 1) * self.ld if self.grid > 1 else 0

    def describe(self) -> str:
        rows = [len(self.rows(g)) for g in range(self.grid)]
        return (f"G={self.grid}, rows per CTA {min(rows)}-{max(rows)}, A in "
                f"shared memory {self.a_smem_bytes} of {4 * self.m * self.n}"
                f" bytes ({sum(self.a_smem)}/{self.grid} CTAs), "
                f"{self.threads} threads ({self.threads // self.col_threads}"
                f" row sets of {self.col_threads}), vectors in "
                f"{'shared memory' if self.vec_smem else 'scratch'}, "
                f"{'split' if self.split else 'replicated'} sums, "
                f"{self.smem_bytes} B dynamic shared memory")


def _cut_points(m: int, blocks, tri) -> np.ndarray:
    """Rows where A may be cut: 0..m except inside an SOC/RSOC block or an
    exp/pow 3-block."""
    inside = np.zeros(m + 2, np.int64)
    for start, dim in [(b[0], b[1]) for b in blocks] + [(t[0], 3)
                                                        for t in tri]:
        inside[start + 1] += 1
        inside[start + dim] -= 1
    return np.flatnonzero(np.cumsum(inside)[:m + 1] == 0)


def _cuts(m: int, grid: int, points: np.ndarray) -> tuple:
    """First rows of ``grid`` slices as even as the cut points allow
    (each ideal cut snapped to the nearest point; empty slices dropped)."""
    ideal = (np.arange(1, grid) * m + grid // 2) // grid
    idx = np.searchsorted(points, ideal)
    lo = points[np.maximum(idx - 1, 0)]
    hi = points[np.minimum(idx, len(points) - 1)]
    snapped = np.where(ideal - lo <= hi - ideal, lo, hi)
    return tuple(int(x) for x in np.unique(np.concatenate([[0], snapped,
                                                           [m]])))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _sum_rounds(length: int, count: int) -> int:
    """Rounds of L2 loads in the kernel's ``sum_cols`` over ``length``
    columns of ``count`` partials rows (8 loads in flight per thread)."""
    width = 1
    while width < 32 and width * 2 * length <= THREADS and width < count:
        width *= 2
    return _ceil(length, THREADS // width) * _ceil(count, 8 * width)


def plan(m: int, n: int, tables, sm_count: int, smem_per_block: int,
         split=None, grid=None, vec_smem=None) -> Plan:
    """The launch for an (m, n) A with the cone ``tables`` (from
    :func:`cone_tables`) on a card of ``sm_count`` SMs and
    ``smem_per_block`` bytes of opt-in shared memory per block.

    Every grid size G from 1 to ``sm_count`` is cut (only between cone
    blocks) and costed per pdhg update by the model above, fitted on an
    H100: two matvec passes, each the largest CTA's batches of rows (about
    1.6 us per batch at 4 column steps), plus two grid sums when G > 1
    (about 1 us each, 0.45 us per round of L2 loads of the partials: G
    rows in the replicated mode, a slice of the columns then one row in
    the split mode, which costs a second barrier, about 0.7 us). The
    cheapest G wins, the smaller on a tie. So the n=50 QP (A 102 x 51)
    keeps G = 1, where a grid sum would cost more than the pass it
    shortens; the n=100 LP (400 x 100) takes G = 4; the GP (2001 x 701)
    and the n=1000 LP (4000 x 1000) spread over the SMs with split sums.
    ``split`` None lets the model pick the sums' mode; ``grid`` cuts for
    that G only (at most ``sm_count``); ``vec_smem`` False puts the
    vectors in scratch even where they fit shared memory."""
    if m < 1 or n < 1 or sm_count < 1:
        raise ValueError(f"megakernel plan: m={m}, n={n}, sm={sm_count}")
    kind, blocks, tri, _ = tables
    if len(kind) != m:
        raise ValueError(f"megakernel plan: cone tables for {len(kind)} "
                         f"rows, A has {m}")
    points = _cut_points(m, blocks, tri)
    # the narrowest row set whose STEPS column steps cover n: more row
    # sets, fewer rows each in the pass's dependent chain
    col_threads = 32
    while col_threads < THREADS and col_threads * STEPS < n:
        col_threads *= 2
    sets = THREADS // col_threads
    steps = min(STEPS, _ceil(n, col_threads))
    steps = STEPS if steps == 3 else steps  # the kernel's instantiations
    col_blocks = _ceil(n, col_threads * steps)
    row_len = n + SCALARS  # floats of a partials row the sums read
    ld = _ceil(row_len, 4) * 4
    best, seen = None, set()
    tries = range(1, min(sm_count, m) + 1)
    if grid is not None:
        if not 1 <= grid <= sm_count:
            raise ValueError(f"megakernel plan: grid {grid} on "
                             f"{sm_count} SMs")
        tries = [grid]
    for g_try in tries:
        row_off = _cuts(m, g_try, points)
        if row_off in seen:
            continue
        seen.add(row_off)
        grid = len(row_off) - 1
        sizes = np.diff(row_off)
        ws = workspace_floats(n, int(sizes.max()))
        in_smem = 4 * ws <= VEC_SMEM_BYTES and vec_smem is not False
        a_cap = (smem_per_block - STATIC_SMEM - (4 * ws if in_smem else 0)
                 ) // 4
        a_smem = tuple(bool(r * n <= a_cap) for r in sizes)
        # batches of 8 rows (the kernel's kBatch) per row set
        pass_us = max(_ceil(_ceil(int(r), sets), 8) * col_blocks
                      * BATCH_US[steps] * (1.0 if s else STREAM_FACTOR)
                      for r, s in zip(sizes, a_smem))
        modes = {False: 0.0, True: 0.0}
        if grid > 1:
            modes = {False: SUM_US + TRIP_US * _sum_rounds(row_len, grid),
                     True: SUM_US + BARRIER_US + TRIP_US * (
                         _sum_rounds(_ceil(row_len, grid), grid) + 1)}
        mode = (min(modes, key=lambda k: (modes[k], k)) if split is None
                else bool(split) and grid > 1)
        cost = 2 * (pass_us + modes[mode])
        if best is not None and cost >= best[0]:
            continue
        a_floats = max((r * n for r, s in zip(sizes, a_smem) if s),
                       default=0)
        best = (cost, Plan(
            m=m, n=n, grid=grid, row_off=row_off,
            blk_off=tuple(int(x) for x in np.searchsorted(
                blocks[:, 0], row_off)),
            tri_off=tuple(int(x) for x in np.searchsorted(tri[:, 0],
                                                          row_off)),
            a_smem=a_smem, threads=THREADS, col_threads=col_threads,
            vec_smem=in_smem, split=mode, ws_floats=ws, a_floats=a_floats,
            ld=ld, smem_bytes=4 * ((ws if in_smem else 0) + a_floats),
            update_us=cost))
    return best[1]


def local_tables(pl: Plan, tables):
    """The cone tables as the kernel reads them: each SOC/RSOC block's and
    3-block's start made relative to the first row of the CTA that owns
    it."""
    kind, blocks, tri, tri_alpha = tables
    blocks, tri = blocks.copy(), tri.copy()
    for table, off in ((blocks, pl.blk_off), (tri, pl.tri_off)):
        for g in range(pl.grid):
            table[off[g]:off[g + 1], 0] -= pl.row_off[g]
    return kind, blocks, tri, tri_alpha


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """A launch over ``lanes`` lanes: each lane runs ``plan`` (its G =
    ``plan.grid`` CTAs), lane ``l`` being the CTAs of ``blockIdx.y = l``.
    ``cooperative``: G > 1, so a lane's CTAs meet at grid barriers and
    the launch must hold every CTA resident at once (``lanes * G <=
    sm_count``, one CTA per SM); else each lane is one CTA that never
    waits for another, and the card runs the grid in ``waves`` waves of
    ``sm_count`` CTAs (one CTA an SM, as for the cooperative launch:
    ``__launch_bounds__(512, 1)`` lets a CTA take an SM's registers)."""
    lanes: int
    plan: Plan
    sm_count: int

    @property
    def grid(self) -> int:
        return self.plan.grid

    @property
    def ctas(self) -> int:
        return self.lanes * self.plan.grid

    @property
    def cooperative(self) -> bool:
        return self.plan.grid > 1

    @property
    def waves(self) -> int:
        return _ceil(self.ctas, self.sm_count)

    def describe(self) -> str:
        return (f"{self.lanes} lanes x G={self.grid} = {self.ctas} CTAs, "
                f"{'cooperative' if self.cooperative else 'plain'} launch, "
                f"{self.waves} wave(s) of at most {self.sm_count} CTAs; "
                f"per lane: "
                f"{self.plan.describe()}")


def plan_batch(lanes: int, m: int, n: int, tables, sm_count: int,
               smem_per_block: int, split=None, grid=None,
               vec_smem=None) -> BatchPlan:
    """The launch for ``lanes`` lanes of an (m, n) A with the cone
    ``tables`` on a card of ``sm_count`` SMs and ``smem_per_block`` bytes
    of opt-in shared memory per block.

    Two regimes. While the lanes fit the SMs (``lanes <= sm_count``), each
    lane gets the G that :func:`plan`'s cost model picks among 1 to
    ``sm_count // lanes``: every CTA has an SM of its own, all are
    resident, and the launch is cooperative where G > 1 (its grid
    barriers wait for the lane's G CTAs only). Past that, each lane gets
    one CTA: a lane of one CTA has no barrier, so nothing needs to be
    resident at once, and the card schedules the CTAs in waves as SMs
    free up; a lane that stops early frees its SM for the next lane. The
    other choice, cooperative launches one resident wave at a time, would
    hold every wave until its slowest lane stops, and cost a launch and a
    host round trip a wave. ``grid`` forces each lane's G (more than one
    resident wave raises); ``split`` and ``vec_smem`` pass to
    :func:`plan`."""
    if lanes < 1 or sm_count < 1:
        raise ValueError(f"megakernel plan_batch: lanes={lanes}, "
                         f"sm={sm_count}")
    if grid is not None:
        if grid > 1 and lanes * grid > sm_count:
            raise ValueError(f"megakernel plan_batch: {lanes} lanes x G="
                             f"{grid} is not resident on {sm_count} SMs")
        pl = plan(m, n, tables, sm_count, smem_per_block, split=split,
                  grid=grid, vec_smem=vec_smem)
    elif lanes <= sm_count:
        pl = plan(m, n, tables, sm_count // lanes, smem_per_block,
                  split=split, vec_smem=vec_smem)
    else:
        pl = plan(m, n, tables, sm_count, smem_per_block, split=split,
                  grid=1, vec_smem=vec_smem)
    return BatchPlan(lanes=lanes, plan=pl, sm_count=sm_count)


class _MegaArgs(ctypes.Structure):
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "a", "c_it", "b_it", "c_ex", "b_ex", "dptx", "dpty", "dpts",
            "dpsx", "dpsy", "ux0", "uy0", "us0", "vn0", "vm0", "lane_scal",
            "kind", "blocks", "tri", "tri_alpha", "ux", "uy", "us", "vn",
            "vm", "scal_out", "int_out", "scratch", "row_off", "blk_off",
            "tri_off", "a_smem", "partials", "barrier")]
        + [(name, ctypes.c_int) for name in (
            "lanes", "a_shared", "m", "n", "nb", "nt", "max_iter",
            "check_period", "halpern", "check_at_start", "grid", "rows_max",
            "col_threads", "split", "vec_smem", "a_floats", "ws_floats",
            "ld")]
        + [(name, ctypes.c_float) for name in (
            "eps_acc", "eps_inf", "eps_zero", "relax")])


def _lib():
    lib = _build.load("megakernel")
    if not getattr(lib, "_typed", False):
        lib.totsu_mega_solve.argtypes = [ctypes.POINTER(_MegaArgs),
                                         ctypes.c_void_p]
        lib.totsu_mega_solve.restype = ctypes.c_int
        lib.totsu_mega_workspace_floats.argtypes = [ctypes.c_int,
                                                    ctypes.c_int]
        lib.totsu_mega_workspace_floats.restype = ctypes.c_longlong
        lib.totsu_mega_smem_optin.argtypes = [ctypes.c_int]
        lib.totsu_mega_smem_optin.restype = ctypes.c_int
        for name in ("totsu_mega_struct_size", "totsu_mega_threads",
                     "totsu_mega_scalars"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if (lib.totsu_mega_struct_size() != ctypes.sizeof(_MegaArgs)
                or lib.totsu_mega_threads() != THREADS
                or lib.totsu_mega_scalars() != SCALARS
                or any(lib.totsu_mega_workspace_floats(n, r)
                       != workspace_floats(n, r)
                       for n, r in ((1, 1), (701, 69), (1000, 48)))):
            raise RuntimeError("megakernel: MegaArgs or plan layout "
                               "mismatch")
        lib._typed = True
    return lib


_plans = {}  # (lanes, m, n, cone, device, overrides) -> plan and tables


def device_plan_batch(lanes: int, m: int, n: int, cone: ConeLayout, device):
    """``(BatchPlan, plan tensors, cone tables)`` for ``lanes`` lanes of an
    (m, n) problem on ``device`` (a CUDA device), the tables on the card;
    cached."""
    key = (lanes, m, n, cone, device, tuple(sorted(PLAN_OVERRIDES.items())))
    hit = _plans.get(key)
    if hit is None:
        lib = _lib()
        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        props = torch.cuda.get_device_properties(device)
        smem = lib.totsu_mega_smem_optin(index)
        if smem <= 0:
            raise RuntimeError("megakernel: cannot read the card's shared "
                               "memory per block")
        tables = cone_tables(cone)
        bp = plan_batch(lanes, m, n, tables, props.multi_processor_count,
                        smem, **PLAN_OVERRIDES)
        pl = bp.plan
        ints = [torch.tensor(np.asarray(x, np.int32), device=device)
                for x in (pl.row_off, pl.blk_off, pl.tri_off, pl.a_smem)]
        loc = [torch.tensor(t, device=device)
               for t in local_tables(pl, tables)]
        hit = _plans[key] = (bp, ints, loc)
    return hit


def device_plan(m: int, n: int, cone: ConeLayout, device):
    """``(Plan, plan tensors, cone tables)`` of a single solve (a batch of
    one lane) on ``device``; cached."""
    bp, ints, loc = device_plan_batch(1, m, n, cone, device)
    return bp.plan, ints, loc


def solve_mega_plain(a, c_it, b_it, c_ex, b_ex, dp_tau, dp_sigma, u0, v0,
                     cone: ConeLayout, *, eps_acc: float, eps_inf: float,
                     eps_zero: float, max_iter: int, check_period: int,
                     relax: float = 1.0, accel: str = "", sb=None, sc=None,
                     check_at_start: bool = False):
    """The plain version: the host loop of ``solver/conic.py`` on the same
    inputs, returning the same ``(u, v, k, status, crits)`` contract."""
    from totsu_tpu_torch.solver import conic
    from totsu_tpu_torch.solver.operator import DenseOp
    a_op = DenseOp(a)
    update = conic._make_update(a_op, c_it, b_it, dp_tau, dp_sigma, cone,
                                relax)
    check = conic._make_check(
        a_op, c_ex, b_ex, torch.linalg.vector_norm(b_ex),
        torch.linalg.vector_norm(c_ex), sb, sc, eps_acc, eps_inf, eps_zero,
        max_iter)
    return conic.run_loop(update, check, u0, v0, cap=max_iter,
                          check_period=check_period, accel=accel,
                          check_at_start=check_at_start, dtype=a.dtype,
                          device=a.device)[:5]


def solve_mega_batch_plain(a, c_it, b_it, c_ex, b_ex, dp_tau, dp_sigma, u0,
                           v0, cone: ConeLayout, *, eps_acc: float,
                           eps_inf: float, eps_zero: float, max_iter: int,
                           check_period: int, relax: float = 1.0,
                           accel: str = "", sb=None, sc=None,
                           check_at_start: bool = False):
    """The batch's plain version: :func:`solve_mega_plain` on each lane's
    inputs, the results stacked (:func:`solve_mega_batch`'s contract)."""
    outs = []
    for i in range(a.shape[0]):
        def lane(t):
            return None if t is None else t[i]

        outs.append(solve_mega_plain(
            a[i], c_it[i], b_it[i], c_ex[i], b_ex[i],
            tuple(map(lane, dp_tau)), tuple(map(lane, dp_sigma)),
            tuple(map(lane, u0)), tuple(map(lane, v0)), cone,
            eps_acc=eps_acc, eps_inf=eps_inf, eps_zero=eps_zero,
            max_iter=max_iter, check_period=check_period, relax=relax,
            accel=accel, sb=lane(sb), sc=lane(sc),
            check_at_start=check_at_start))
    u = tuple(torch.stack([o[0][j] for o in outs]) for j in range(4))
    v = tuple(torch.stack([o[1][j] for o in outs]) for j in range(3))
    k = torch.tensor([o[2] for o in outs], dtype=torch.int64,
                     device=a.device)
    status = torch.tensor([int(o[3]) for o in outs], dtype=torch.int32,
                          device=a.device)
    return u, v, k, status, torch.stack([o[4] for o in outs])


def _check_batch(a, vecs, lanes, m, n):
    if a.dtype != torch.float32 or a.dim() != 3 \
            or tuple(a.shape) != (lanes, m, n):
        raise ValueError("megakernel: A must be a (B, m, n) f32 tensor")
    if not a[0].is_contiguous() or (lanes > 1
                                     and a.stride(0) not in (0, m * n)):
        raise ValueError("megakernel: each lane's A must be contiguous, "
                         "the lanes m n floats apart or all one matrix")
    for name, t, length in vecs:
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"megakernel: {name} must be f32 on {a.device}")
        want = (lanes, length) if length is not None else (lanes,)
        if tuple(t.shape) != want:
            raise ValueError(f"megakernel: {name} has shape "
                             f"{tuple(t.shape)}, not {want}")
        if not t.is_contiguous():
            raise ValueError(f"megakernel: {name} must be contiguous")


def _launch(a, c_it, b_it, c_ex, b_ex, dp_tau, dp_sigma, u0, v0,
            cone: ConeLayout, *, eps_acc: float, eps_inf: float,
            eps_zero: float, max_iter: int, check_period: int,
            relax: float = 1.0, accel: str = "", sb=None, sc=None,
            check_at_start: bool = False):
    """One launch of the whole-solve CUDA kernel over every lane of
    lane-leading CUDA tensors, on :func:`device_plan_batch`'s grid; raises
    when the build or the launch fails (for one, a cooperative grid the
    card cannot hold resident at once). Reads nothing back to the host and
    counts nothing: each wrapper counts its own launches."""
    if accel not in ("", "halpern"):
        raise ValueError(f"megakernel: unsupported accel {accel!r}")
    if not supported(cone):
        raise ValueError("megakernel: unsupported cone layout")
    lanes, m, n = a.shape
    if cone.dim != m:
        raise ValueError(f"megakernel: cone dim {cone.dim} != m {m}")
    vecs = [("c_it", c_it, n), ("b_it", b_it, m), ("c_ex", c_ex, n),
            ("b_ex", b_ex, m), ("dp_tau[0]", dp_tau[0], n),
            ("dp_tau[1]", dp_tau[1], m), ("dp_tau[2]", dp_tau[2], m),
            ("dp_tau[3]", dp_tau[3], None), ("dp_sigma[0]", dp_sigma[0], n),
            ("dp_sigma[1]", dp_sigma[1], m), ("dp_sigma[2]", dp_sigma[2], None),
            ("u0[0]", u0[0], n), ("u0[1]", u0[1], m), ("u0[2]", u0[2], m),
            ("u0[3]", u0[3], None), ("v0[0]", v0[0], n), ("v0[1]", v0[1], m),
            ("v0[2]", v0[2], None)]
    _check_batch(a, vecs, lanes, m, n)
    dev = a.device
    one = torch.ones(lanes, dtype=torch.float32, device=dev)
    lane_scal = torch.stack([
        dp_tau[3], dp_sigma[2], torch.linalg.vector_norm(b_ex, dim=-1),
        torch.linalg.vector_norm(c_ex, dim=-1), u0[3], v0[2],
        one if sb is None else sb.to(torch.float32),
        one if sc is None else sc.to(torch.float32)], dim=-1).contiguous()
    bp, (row_off, blk_off, tri_off, a_smem), tables = device_plan_batch(
        lanes, m, n, cone, dev)
    pl = bp.plan
    kind, blocks, tri, tri_alpha = tables

    lib = _lib()
    out = {name: torch.empty((lanes, length), dtype=torch.float32,
                             device=dev)
           for name, length in (("ux", n), ("uy", m), ("us", m), ("vn", n),
                                ("vm", m), ("scal_out", 7))}
    int_out = torch.empty((lanes, 2), dtype=torch.int32, device=dev)
    scratch = torch.empty(
        0 if pl.vec_smem else lanes * pl.grid * pl.ws_floats,
        dtype=torch.float32, device=dev)
    partials = torch.empty(lanes * pl.partials_len, dtype=torch.float32,
                           device=dev)
    barrier = torch.zeros(lanes, dtype=torch.int32, device=dev)
    args = _MegaArgs(
        a=a.data_ptr(), c_it=c_it.data_ptr(), b_it=b_it.data_ptr(),
        c_ex=c_ex.data_ptr(), b_ex=b_ex.data_ptr(),
        dptx=dp_tau[0].data_ptr(), dpty=dp_tau[1].data_ptr(),
        dpts=dp_tau[2].data_ptr(), dpsx=dp_sigma[0].data_ptr(),
        dpsy=dp_sigma[1].data_ptr(), ux0=u0[0].data_ptr(),
        uy0=u0[1].data_ptr(), us0=u0[2].data_ptr(), vn0=v0[0].data_ptr(),
        vm0=v0[1].data_ptr(), lane_scal=lane_scal.data_ptr(),
        kind=kind.data_ptr(), blocks=blocks.data_ptr(), tri=tri.data_ptr(),
        tri_alpha=tri_alpha.data_ptr(),
        **{name: t.data_ptr() for name, t in out.items()},
        int_out=int_out.data_ptr(),
        scratch=scratch.data_ptr() if scratch.numel() else None,
        row_off=row_off.data_ptr(), blk_off=blk_off.data_ptr(),
        tri_off=tri_off.data_ptr(), a_smem=a_smem.data_ptr(),
        partials=partials.data_ptr() if partials.numel() else None,
        barrier=barrier.data_ptr(), lanes=lanes,
        a_shared=int(a.stride(0) == 0 and lanes > 1), m=m, n=n,
        nb=blocks.shape[0], nt=tri.shape[0], max_iter=int(max_iter),
        check_period=int(check_period), halpern=int(accel == "halpern"),
        check_at_start=int(bool(check_at_start)), grid=pl.grid,
        rows_max=pl.rows_max, col_threads=pl.col_threads,
        split=int(pl.split), vec_smem=int(pl.vec_smem),
        a_floats=pl.a_floats, ws_floats=pl.ws_floats, ld=pl.ld,
        eps_acc=float(eps_acc), eps_inf=float(eps_inf),
        eps_zero=float(eps_zero), relax=float(relax))
    with torch.cuda.device(dev):  # launch on A's card
        rc = lib.totsu_mega_solve(ctypes.byref(args),
                                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "megakernel launch")
    so = out["scal_out"]
    u = (out["ux"], out["uy"], out["us"], so[:, 0])
    v = (out["vn"], out["vm"], so[:, 1])
    return u, v, int_out[:, 0].to(torch.int64), int_out[:, 1], so[:, 2:7]


def solve_mega_batch_cuda(a, *args, **kwargs):
    """Launch the whole-solve CUDA kernel over every lane (CUDA tensors
    only): one launch, counted in ``batch_launches``; raises when the build
    or the launch fails."""
    global batch_launches
    if a.device.type != "cuda":
        raise ValueError("solve_mega_batch_cuda: tensors must be on a CUDA "
                         "device")
    out = _launch(a, *args, **kwargs)
    batch_launches += 1
    return out


def solve_mega_batch(a, *args, **kwargs):
    """Run every lane's whole pdhg solve: ``a`` (B, m, n) (one matrix
    expanded over the lanes is not copied), every other input lane-leading
    as :func:`solve_mega`'s with a (B,) tensor for each of its scalars (sb
    and sc (B,) or None). Returns ``(u, v, k (B,), status (B,), crits
    (B, 5))``, u and v lane-leading. The CUDA kernel for CUDA tensors (one
    launch), the plain version for CPU tensors."""
    if a.device.type == "cuda":
        return solve_mega_batch_cuda(a, *args, **kwargs)
    if a.device.type == "cpu":
        return solve_mega_batch_plain(a, *args, **kwargs)
    raise ValueError(f"megakernel: unsupported device {a.device}")


def solve_mega_cuda(a, c_it, b_it, c_ex, b_ex, dp_tau, dp_sigma, u0, v0,
                    cone: ConeLayout, *, sb=None, sc=None, **kwargs):
    """Launch the whole-solve CUDA kernel (CUDA tensors only) for one
    solve: one launch on a batch of one lane, whose plan is :func:`plan`'s,
    counted in ``launches``; raises when the build or the launch fails."""
    global launches
    if a.device.type != "cuda":
        raise ValueError("solve_mega_cuda: tensors must be on a CUDA device")
    if a.dim() != 2:
        raise ValueError("megakernel: A must be an (m, n) f32 tensor")

    def one(t):
        return None if t is None else t.unsqueeze(0)

    u, v, k, status, crits = _launch(
        one(a), one(c_it), one(b_it), one(c_ex), one(b_ex),
        tuple(map(one, dp_tau)), tuple(map(one, dp_sigma)),
        tuple(map(one, u0)), tuple(map(one, v0)), cone, sb=one(sb),
        sc=one(sc), **kwargs)
    launches += 1
    k, status = torch.stack([k, status.to(torch.int64)], -1)[0].tolist()
    return (tuple(t[0] for t in u), tuple(t[0] for t in v), k, status,
            crits[0])


def solve_mega(a, *args, **kwargs):
    """Run the whole pdhg solve: the CUDA kernel for CUDA tensors, the
    plain version (the host loop) for CPU tensors."""
    if a.device.type == "cuda":
        return solve_mega_cuda(a, *args, **kwargs)
    if a.device.type == "cpu":
        return solve_mega_plain(a, *args, **kwargs)
    raise ValueError(f"megakernel: unsupported device {a.device}")
