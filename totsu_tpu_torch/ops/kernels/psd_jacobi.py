"""Kernel J: the Jacobi PSD-cone projection of packed symmetric blocks.
Wrapper of the CUDA kernel in ``csrc/psd_jacobi.cu``, its launch plan, its
block table and its plain PyTorch version.

The JAX package has no Pallas kernel here: XLA compiles the parallel-order
Jacobi eigendecomposition (``totsu_tpu/ops/jacobi.py`` ``jacobi_eigh``,
``psd_part_jacobi``: 10-14 sweeps of k-1 rounds) into one program. Eager
PyTorch would launch about 40 operations per round, thousands per
projection, so on a CUDA tensor :func:`proj_psd_jacobi` projects all
(count, k(k+1)/2) blocks of a factor in one launch, a thread-block cluster
per block (:func:`plan`); on a CPU tensor it runs
:func:`proj_psd_jacobi_plain` (``ops/jacobi.py``). A CUDA tensor launches
the kernel or raises.

The kernel keeps A by position (the round-robin schedule's seats), as
2 x 2 blocks of pairs; :func:`block_table` says, for each CTA's block
slots, the pairs (P, Q) of the slot and where each of its four values goes
after the round (the block of its next positions: a CTA of the cluster and
an offset) and which of them are the next round's diagonals or pivots.
"""

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from totsu_tpu_torch.ops import jacobi, sympack
from totsu_tpu_torch.ops.kernels import _build

#: kernel launches since the last reset (CUDA only; the plain version
#: does not count)
launches = 0

_ENTRY = {torch.float32: "totsu_psd_jacobi_f32",
          torch.float64: "totsu_psd_jacobi_f64"}
_C_PTR = ctypes.c_void_p

#: threads per CTA at most (``psd_jacobi.cu`` ``kMaxThreads``)
MAX_THREADS = 512
#: block slots a thread holds in registers (``slots_held``), with A split
#: over the cluster and with the whole of A in each CTA
SLOTS_PER_THREAD = {True: 4, False: 6}
#: the cluster sizes the kernel takes; above 8 a non-portable size
CLUSTERS = (1, 2, 4, 8, 16)
PORTABLE_CLUSTER = 8
#: shared memory a launch may use without ``cudaFuncSetAttribute``
DEFAULT_SMEM = 48 * 1024
#: the largest order the plan takes (a destination's offset has 24 bits)
MAX_K = 4096
#: ints per block slot of the table (``kDesc``)
DESC = 8
#: the cluster a block of order kp wants while the card has SMs to spare,
#: as (largest kp, cluster), else 16; ``jacobi_timing.py --sweep`` reads
#: the choice (PERF.md)
CLUSTER_WANT = ((16, 1), (64, 4), (192, 8))
#: count x cluster stays within the SMs over this: a cluster sits in one
#: GPC, so clusters of 8 at count 16 (128 of 132 SMs) ran in two waves
SM_SHARE = 2
#: V items and block slots a thread takes per round, at the most threads
ITEMS_PER_THREAD = 2
#: ``cluster=`` / ``threads=`` / ``split=`` forced on :func:`device_plan`
#: (to check or time a layout the plan would not pick)
PLAN_OVERRIDES = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the kernel: ``count`` clusters of ``cluster`` CTAs of
    ``threads`` threads, one cluster per block matrix. Each CTA holds
    ``rows`` rows of V and ``slots`` block slots of A (``held`` in its
    threads' registers, or read from the table): with ``split``, its share
    of A's slots (the values that leave it and the next round's pivots go
    into the other CTAs' shared memory, a cluster barrier a round); else
    the whole of A, which every CTA updates alike (the cluster splits only
    V and the rebuild). ``smem_layout``: A (two buffers), V and the warps'
    rotation tables in shared memory, ``smem_bytes`` per CTA (above 48 KB
    only after ``cudaFuncSetAttribute``: ``set_attribute``); else they
    live in a global scratch of ``scratch_elems`` values per block and the
    cluster is 1. ``nonportable``: a cluster above 8 CTAs."""
    k: int
    kp: int
    count: int
    cluster: int
    threads: int
    smem_layout: bool
    split: bool
    rows: int
    slots: int
    smem_bytes: int
    scratch_elems: int
    set_attribute: bool
    nonportable: bool

    @property
    def warps(self) -> int:
        return self.threads // 32

    @property
    def held(self) -> bool:
        """Each thread holds its block slots in registers (else it reads
        them from the table each round)."""
        return self.smem_layout and \
            self.warp_slots <= 32 * SLOTS_PER_THREAD[self.split]

    @property
    def warp_slots(self) -> int:
        """A warp's run of block slots (lane i takes i, i + 32, ...)."""
        return -(-self.slots // self.warps)

    def describe(self) -> str:
        where = ("A and V in global scratch" if not self.smem_layout else
                 "A split over the cluster and V in shared memory"
                 if self.split else "A whole in each CTA and V in shared "
                 "memory")
        return (f"k={self.k}: {self.count} x {self.cluster} CTA"
                f"{'s' if self.cluster > 1 else ''} x {self.threads} "
                f"threads, {where}, {self.rows} rows of V and "
                f"{self.slots} block slots per CTA"
                + ("" if self.held else " (read from the table)")
                + f", {self.smem_bytes} B "
                f"shared" + (" (opt-in)" if self.set_attribute else "")
                + (" (non-portable cluster)" if self.nonportable else ""))


def _elem(dtype) -> int:
    if dtype not in _ENTRY:
        raise ValueError(f"psd_jacobi plan: dtype {dtype}")
    return torch.empty(0, dtype=dtype).element_size()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _sizes(kp: int, threads: int, rows: int, slots: int, elem: int):
    """``psd_jacobi.cu`` ``Sizes``: (A's two buffers, V, the pivot array's
    two slots or each pair's diagonal slot, each warp's c and s of each
    pair and list of the pairs it needs), in values."""
    w = 16 // elem
    warp = _round_up(kp, w) + _round_up(4 * (kp // 2), 16) // elem
    return (_round_up(max(8 * slots, kp * rows), w), kp * rows,
            _round_up(2 * (kp + kp // 2 + 1), w), (threads // 32) * warp)


def smem_bytes(kp: int, threads: int, rows: int, slots: int, elem: int,
               smem_layout: bool) -> int:
    """Dynamic shared memory of a launch (``psd_jacobi.cu``
    ``smem_bytes``): all four regions in the shared-memory layout, the
    third (each pair's diagonal slot) alone in the global one."""
    region, v, piv, rot = _sizes(kp, threads, rows, slots, elem)
    return elem * (region + v + piv + rot if smem_layout else piv)


def scratch_elems(kp: int, threads: int, rows: int, slots: int,
                  elem: int) -> int:
    """Global scratch of one block matrix in the global layout, in values
    (``psd_jacobi.cu`` ``scratch_elems``)."""
    region, v, _, rot = _sizes(kp, threads, rows, slots, elem)
    return region + v + rot


def rows_per_cta(kp: int, cluster: int, elem: int) -> int:
    """Rows of V per CTA: kp / cluster, rounded up to 16 bytes."""
    return _round_up(-(-kp // cluster), 16 // elem)


def _threads(slots: int, items: int, split: bool) -> int:
    t = _round_up(-(-max(slots, items) // ITEMS_PER_THREAD), 32)
    t = max(t, 32 * -(-slots // (32 * SLOTS_PER_THREAD[split])))
    return max(32, min(MAX_THREADS, t))


def _layout(kp: int, cluster: int, elem: int, split: bool, threads=None):
    """(threads, rows, slots, smem bytes) of the shared-memory layout on
    ``cluster`` CTAs, A split over them or whole in each."""
    slots = sympack.tri_len(kp // 2)
    if split:
        slots = -(-slots // cluster)
    rows = rows_per_cta(kp, cluster, elem)
    t = threads or _threads(slots, kp // 2 * rows // (16 // elem), split)
    return t, rows, slots, smem_bytes(kp, t, rows, slots, elem, True)


def plan(k: int, count: int, dtype: torch.dtype, smem_per_block: int,
         sms: int = 132, cluster: Optional[int] = None,
         threads: Optional[int] = None,
         split: Optional[bool] = None) -> Plan:
    """The launch for ``count`` blocks of order ``k`` in ``dtype`` on a
    card of ``sms`` SMs whose blocks may use ``smem_per_block`` bytes of
    shared memory. The cluster size the block wants: what its order wants
    (``CLUSTER_WANT``) while count x cluster stays within a
    ``SM_SHARE``-th of the SMs, else 1. Where A's two buffers fit one CTA,
    each CTA of a cluster of that
    size holds the whole of A (the least size whose layout fits, at or
    above it); else A is split over the least cluster that holds its
    share and V in shared memory and its block slots in registers (or,
    failing that, the least that holds A and V), raised to that size.
    Past 16 CTAs' shared memory, the global layout on one CTA. Threads:
    enough for ``ITEMS_PER_THREAD`` block slots and V items (of 16 bytes)
    each, and for the ``SLOTS_PER_THREAD`` slots a thread holds in
    registers, in whole warps, at most ``MAX_THREADS``. ``cluster`` /
    ``threads`` / ``split`` force a choice."""
    elem = _elem(dtype)
    if not 1 <= k <= MAX_K or count < 0 or smem_per_block < 1 or sms < 1:
        raise ValueError(f"psd_jacobi plan: k {k}, count {count}, "
                         f"smem_per_block {smem_per_block}, sms {sms}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"psd_jacobi plan: cluster {cluster}")
    if threads is not None and (threads % 32 or
                                not 32 <= threads <= MAX_THREADS):
        raise ValueError(f"psd_jacobi plan: threads {threads}")
    kp = k + k % 2
    fits = {}  # (cluster, split) -> layout
    for sp in (False, True):
        for c in CLUSTERS[sp:]:
            lay = _layout(kp, c, elem, sp, threads)
            if lay[3] <= smem_per_block and split in (None, sp):
                fits[(c, sp)] = lay
    want = next((c for top, c in CLUSTER_WANT if kp <= top), 16)
    size = min(want, max(x for x in CLUSTERS
                         if x == 1 or count * x * SM_SHARE <= sms))
    whole = [c for c, sp in fits if not sp]
    parts = [c for c, sp in fits if sp]
    if cluster is not None:
        if cluster in whole or cluster in parts:
            pick = (cluster, cluster not in whole)
        else:
            raise ValueError(f"psd_jacobi plan: k {k} does not fit a "
                             f"cluster of {cluster}")
    elif whole:
        pick = (min([c for c in whole if c >= size] or [max(whole)]), False)
    elif parts:
        # the least cluster whose threads hold their slots, else the least
        held = [c for c in parts
                if fits[(c, True)][2] <= SLOTS_PER_THREAD[True]
                * fits[(c, True)][0]]
        least = min(held or parts)
        pick = (min(c for c in parts if c >= max(least, size)), True)
    else:
        pick = None
    if pick is not None:
        t, rows, slots, smem = fits[pick]
        return Plan(k, kp, count, pick[0], t, True, pick[1], rows, slots,
                    smem, 0, smem > DEFAULT_SMEM,
                    pick[0] > PORTABLE_CLUSTER)
    # the global layout: one CTA, each pair's diagonal slot alone in
    # shared memory
    rows = rows_per_cta(kp, 1, elem)
    slots = sympack.tri_len(kp // 2)
    t = threads or MAX_THREADS
    smem = smem_bytes(kp, t, rows, slots, elem, False)
    if smem > smem_per_block:
        raise ValueError(f"psd_jacobi plan: k {k} needs {smem} B of shared "
                         f"memory, the card gives {smem_per_block}")
    return Plan(k, kp, count, 1, t, False, False, rows, slots, smem,
                scratch_elems(kp, t, rows, slots, elem),
                smem > DEFAULT_SMEM, False)


def _next_pos(p, kp):
    """The position a player at position ``p`` takes in the next round
    (``ops/jacobi.py`` ``_schedule``: position 0 keeps player 0, the last
    position's player goes to 1, the others one on)."""
    return np.where(p == 0, 0, np.where(p == kp - 1, 1, p + 1))


def player(p, r, kp):
    """The player (row) at position ``p`` in round ``r`` of the schedule
    over kp players (``psd_jacobi.cu`` ``player``), 0 <= r < kp-1."""
    n = kp - 1
    p = np.asarray(p)
    return np.where(p == 0, 0, np.where(p > r, p - r, p - r + n))


def _tiled(p, q, parts, run):
    """Blocks in square tiles of side about sqrt(blocks / parts), each cut
    into square sub-tiles of side about sqrt(run), tiles and sub-tiles in
    row-major order and (P, Q) row-major within a sub-tile: compact
    patches of the triangle for a CTA and for a warp's run of slots (a
    value moves to a neighbouring block, (P +- 1, Q +- 1), per round, and
    a warp computes the rotations of the pairs its blocks touch)."""
    big = max(1, int(round(math.sqrt(len(p) / parts))))
    small = max(1, int(round(math.sqrt(run))))
    order = np.lexsort((q, p, q // small, p // small, q // big, p // big))
    return p[order], q[order]


def block_order(h: int, cluster: int, threads: int = 32):
    """The blocks of pairs (P, Q), P <= Q < h, in the order the CTAs own
    them (slots ``c * slots ...`` for CTA c, warp w of its ``threads //
    32`` taking the run ``w * sw ...`` of sw = slots / warps): in compact
    tiles (:func:`_tiled`). Split over a cluster, each CTA first takes an
    equal run of the band Q - P <= 2 along the diagonal (the blocks whose
    values are the next round's pivots and diagonals, which go to every
    CTA), spread over its warps' runs, then an equal share of the other
    blocks in tiles."""
    p, q = np.triu_indices(h)
    nblk = len(p)
    warps = max(1, threads // 32)
    if cluster == 1:
        return _tiled(p, q, 1, -(-nblk // warps))
    slots = -(-nblk // cluster)
    sw = -(-slots // warps)
    band = q - p <= 2
    bp, bq = p[band], q[band]  # row-major: along the diagonal
    rp, rq = _tiled(p[~band], q[~band], cluster, sw)
    size = [max(0, min(slots, nblk - c * slots)) for c in range(cluster)]
    runs = [r[:size[c]] for c, r in
            enumerate(np.array_split(np.arange(len(bp)), cluster))]
    # the band blocks that do not fit their CTA join the others, first
    left = np.setdiff1d(np.arange(len(bp)), np.concatenate(runs))
    pool_p = np.concatenate([bp[left], rp])
    pool_q = np.concatenate([bq[left], rq])
    out_p, out_q, taken = [], [], 0
    for c, run in enumerate(runs):
        i = np.arange(len(run))
        spread = (i % warps) * sw + i // warps
        ok = spread < size[c]
        free = np.setdiff1d(np.arange(size[c]), spread[ok])
        place = np.concatenate([spread[ok], free[:np.count_nonzero(~ok)]])
        cp = np.empty(size[c], np.int64)
        cq = np.empty(size[c], np.int64)
        cp[place], cq[place] = bp[run], bq[run]
        others = np.setdiff1d(np.arange(size[c]), place)
        cp[others] = pool_p[taken:taken + len(others)]
        cq[others] = pool_q[taken:taken + len(others)]
        taken += len(others)
        out_p.append(cp)
        out_q.append(cq)
    return np.concatenate(out_p), np.concatenate(out_q)


def block_table(kp: int, cluster: int, threads: int = 32) -> np.ndarray:
    """The (cluster, slots, 8) int32 table of the kernel's block slots:
    CTA ``c`` owns slots ``c * slots ...`` of :func:`block_order` (for
    CTAs of ``threads``). A slot
    holds the four values of A at positions (P, Q), (P, Q'), (P', Q),
    (P', Q') (X' = kp-1-X; on P == Q the third is the second's mirror and
    unused). Its row: ``P | Q << 16``, the four values' destinations
    (``cta << 24 | value * slots + slot``, the slot of their next
    positions' block, where the CTA keeps value e of slot l at e * slots +
    l; the unused mirror goes to its own place, which nobody reads),
    then two words of two 16-bit indices into the pivot array: the value's
    next position where it is a diagonal, kp + P'' where it is the next
    round's pivot of pair P'', else the sink kp + kp/2. An empty slot's
    row is all ones (-1)."""
    h = kp // 2
    p, q = block_order(h, cluster, threads)
    nblk = len(p)
    slots = -(-nblk // cluster)
    gid = np.full((h, h), -1, np.int64)
    gid[p, q] = np.arange(nblk)
    hi = kp - 1
    rows = np.full((cluster * slots, DESC), 0xFFFFFFFF, np.uint32)
    rows[:nblk, 0] = p | (q << 16)
    rows[:nblk, 7] = 0
    pivs = []
    for e, (u, v) in enumerate(((p, q), (p, hi - q), (hi - p, q),
                                (hi - p, hi - q))):
        nu, nv = _next_pos(u, kp), _next_pos(v, kp)
        pu, pv = np.minimum(nu, hi - nu), np.minimum(nv, hi - nv)
        row = np.where(pu <= pv, nu, nv)       # the position of the
        col = np.where(pu <= pv, nv, nu)       # smaller pair: the row
        bp, bq = np.minimum(pu, pv), np.maximum(pu, pv)
        value = np.where(bp == bq,
                         np.where(row == col, np.where(row >= h, 3, 0), 1),
                         2 * (row >= h) + (col >= h))
        g = gid[bp, bq]
        code = ((g // slots) << 24) | (value * slots + g % slots)
        piv = np.where(nu == nv, nu, np.where(nu + nv == hi,
                                              kp + np.minimum(nu, nv),
                                              kp + h))
        if e == 2:  # the diagonal block's mirror value: to its own place
            own = np.arange(nblk)
            code = np.where(p == q, ((own // slots) << 24)
                            | (2 * slots + own % slots), code)
            piv = np.where(p == q, kp + h, piv)
        rows[:nblk, 1 + e] = code
        pivs.append(piv)
    rows[:nblk, 5] = pivs[0] | (pivs[1] << 16)
    rows[:nblk, 6] = pivs[2] | (pivs[3] << 16)
    return rows.view(np.int32).reshape(cluster, slots, DESC)


def ops_count(k: int, count: int, sweeps: int) -> int:
    """The operations of one call, counted from the algorithm (adds,
    multiplies, divides, square roots and compares each 1): per round and
    pair the rotation (14), per pair of pairs P < Q its 2 x 2 block (24;
    21 on P == Q, whose two off-diagonal entries are one), per row and
    pair the column update (6); then max and sqrt of each eigenvalue, the
    k x k scaling of V by them, 2 per term of each output entry of the
    rebuild, and the unpacking and packing one each per entry. A rotation
    that the kernel computes again in each warp counts once."""
    kp = k + k % 2
    h = kp // 2
    per_round = (14 * h + 24 * (sympack.tri_len(h) - h) + 21 * h
                 + 6 * h * kp)
    sn = sympack.tri_len(k)
    return count * (sweeps * (kp - 1) * per_round + 2 * k + k * k
                    + 2 * k * sn + 2 * sn)


def _check_args(v: torch.Tensor):
    if v.dim() != 2:
        raise ValueError(f"psd_jacobi: blocks must be (count, k(k+1)/2), "
                         f"got {tuple(v.shape)}")
    if v.dtype not in _ENTRY:
        raise TypeError(f"psd_jacobi: blocks must be f32 or f64, got "
                        f"{v.dtype}")
    return sympack.order_from_len(v.shape[1])


def proj_psd_jacobi_plain(v: torch.Tensor, scaled: bool = True,
                          sweeps: Optional[int] = None) -> torch.Tensor:
    """The PSD projection of (..., k(k+1)/2) packed blocks by
    :func:`jacobi.psd_part_jacobi` (scaled-vec convention when
    ``scaled``)."""
    k = sympack.order_from_len(v.shape[-1])
    x = sympack.unpack(v, k, scaled=scaled)
    return sympack.pack(jacobi.psd_part_jacobi(x, sweeps), scaled=scaled)


def _lib():
    lib = _build.load("psd_jacobi")
    if not getattr(lib, "_typed", False):
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [_C_PTR] * 4 + [ctypes.c_int] * 10 + [
                ctypes.c_longlong, _C_PTR]
            fn.restype = ctypes.c_int
        lib.totsu_psd_jacobi_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.totsu_psd_jacobi_smem_bytes.restype = ctypes.c_longlong
        lib.totsu_psd_jacobi_scratch_elems.argtypes = [ctypes.c_int] * 5
        lib.totsu_psd_jacobi_scratch_elems.restype = ctypes.c_longlong
        lib.totsu_psd_jacobi_active_clusters.argtypes = [
            ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.totsu_psd_jacobi_active_clusters.restype = ctypes.c_int
        lib.totsu_psd_jacobi_smem_optin.argtypes = [ctypes.c_int]
        lib.totsu_psd_jacobi_smem_optin.restype = ctypes.c_int
        cases = [(kp, t, r, s, e) for kp in (2, 8, 50, 256)
                 for t, r, s in ((32, 8, 10), (160, 52, 300),
                                 (288, 16, 516)) for e in (4, 8)]
        if any(lib.totsu_psd_jacobi_smem_bytes(kp, t, r, s, e, lay)
               != smem_bytes(kp, t, r, s, e, bool(lay))
               or lib.totsu_psd_jacobi_scratch_elems(kp, t, r, s, e)
               != scratch_elems(kp, t, r, s, e)
               for kp, t, r, s, e in cases for lay in (0, 1)):
            raise RuntimeError("psd_jacobi: shared-memory layout mismatch")
        lib._typed = True
    return lib


_card = {}       # device index -> (shared memory per block, SMs)
_tables = {}     # (kp, cluster, threads, device) -> the block table
_scheduled = {}  # (dtype, cluster, threads, smem, layout, device) -> ok


def card_limits(device: torch.device):
    """(shared memory a block may opt in to, SMs) of a CUDA ``device``."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    card = _card.get(index)
    if card is None:
        smem = _lib().totsu_psd_jacobi_smem_optin(index)
        if smem <= 0:
            raise RuntimeError("psd_jacobi: cannot read the card's shared "
                               "memory per block")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        card = _card[index] = (smem, sms)
    return card


def device_plan(k: int, count: int, dtype: torch.dtype,
                device: torch.device) -> Plan:
    """:func:`plan` for the shared memory a block may use and the SMs of
    a CUDA ``device`` (and ``PLAN_OVERRIDES``)."""
    return plan(k, count, dtype, *card_limits(device), **PLAN_OVERRIDES)


def _device_table(pl: Plan, device: torch.device):
    """The plan's block table on the card: split over its cluster, or the
    whole of A (one CTA's table, which every CTA reads)."""
    key = (pl.kp, pl.cluster if pl.split else 1, pl.threads, device)
    tab = _tables.get(key)
    if tab is None:
        tab = _tables[key] = torch.from_numpy(
            block_table(*key[:3])).to(device)
    return tab


def _check_schedulable(lib, pl: Plan, dtype, device: torch.device):
    """Raise unless the card can hold one cluster of the plan
    (``cudaOccupancyMaxActiveClusters``): no smaller layout is tried."""
    key = (dtype, pl.cluster, pl.threads, pl.smem_bytes, pl.smem_layout,
           pl.split, device)
    if key in _scheduled:
        return
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.totsu_psd_jacobi_active_clusters(
            _elem(dtype), pl.cluster, pl.threads, pl.smem_bytes,
            int(pl.smem_layout), int(pl.split), ctypes.byref(out))
    _build.check(lib, rc, "psd_jacobi cluster occupancy")
    if out.value < 1:
        raise RuntimeError(f"psd_jacobi: a cluster of {pl.cluster} CTAs of "
                           f"{pl.threads} threads and {pl.smem_bytes} B "
                           f"cannot be scheduled on {device}")
    _scheduled[key] = True


def proj_psd_jacobi_cuda(v: torch.Tensor, scaled: bool = True,
                         sweeps: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on (count, k(k+1)/2) contiguous blocks on a
    CUDA device, into a new tensor."""
    global launches
    k = _check_args(v)
    if v.device.type != "cuda":
        raise ValueError("proj_psd_jacobi_cuda: tensors must be on a CUDA "
                         "device")
    if not v.is_contiguous():
        raise ValueError("proj_psd_jacobi_cuda: blocks must be contiguous")
    n_sweeps = jacobi.sweeps_for(k, sweeps)
    lib = _lib()
    out = torch.empty_like(v)
    count = v.shape[0]
    if count == 0:
        return out
    pl = device_plan(k, count, v.dtype, v.device)
    _check_schedulable(lib, pl, v.dtype, v.device)
    table = _device_table(pl, v.device)
    scratch = (torch.empty(count * pl.scratch_elems, dtype=v.dtype,
                           device=v.device) if pl.scratch_elems else None)
    with torch.cuda.device(v.device):  # launch on the blocks' card
        rc = getattr(lib, _ENTRY[v.dtype])(
            v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            table.data_ptr(), k, count, n_sweeps, int(bool(scaled)),
            pl.cluster, pl.threads, pl.rows, pl.slots, int(pl.smem_layout),
            int(pl.split), pl.smem_bytes,
            torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(lib, rc, "psd_jacobi launch")
    launches += 1
    return out


def proj_psd_jacobi(v: torch.Tensor, scaled: bool = True,
                    sweeps: Optional[int] = None) -> torch.Tensor:
    """The Jacobi PSD projection of (..., k(k+1)/2) packed blocks: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if v.device.type == "cuda":
        flat = v.reshape(-1, v.shape[-1]).contiguous()
        return proj_psd_jacobi_cuda(flat, scaled, sweeps).reshape(v.shape)
    if v.device.type == "cpu":
        return proj_psd_jacobi_plain(v, scaled, sweeps)
    raise ValueError(f"proj_psd_jacobi: unsupported device {v.device}")
