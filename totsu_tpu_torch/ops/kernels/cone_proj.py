"""Blocked exp/pow cone projection: wrapper of the CUDA kernel in
``csrc/cone_proj.cu``, its launch plan and its plain PyTorch version.

The JAX package has no Pallas kernel here: XLA fuses each fixed-trip
Newton-bisection core (``totsu_tpu/solver/cone.py`` ``_proj_exp_blocks``,
``_proj_pow_blocks``) into one kernel. Eager PyTorch would launch each of
its thousands of elementwise operations separately, so on a CUDA tensor
:func:`cone_proj` projects all (count, 3) blocks of a factor in one
launch, a warp per block (:func:`plan`), with the Moreau dual
formed in the kernel; on a CPU tensor it runs :func:`cone_proj_plain`,
the cores of ``solver/cone.py``. The kernel's arithmetic is
``csrc/cone_exppow.cuh``, which the megakernel shares; its lane-parallel
root finder has a torch model here (:func:`_lane_model`, for the tests:
the same points, the same ballot rule, the same Newton step).
"""

import ctypes
import dataclasses

import torch

from totsu_tpu_torch.ops.kernels import _build
from totsu_tpu_torch.solver import cone as cones

#: kernel launches since the last reset (CUDA only; the plain version
#: does not count)
launches = 0

_KIND = {cones.EXP: 0, cones.POW: 1}
_ENTRY = {torch.float32: "totsu_cone_proj_f32",
          torch.float64: "totsu_cone_proj_f64"}
_C_REAL = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}

#: lanes per block: a warp (``cone_proj.cu`` ``kLanes``)
LANES = 32
#: threads per CTA the plan chooses from, largest first
CTA_THREADS = (256, 128, 64, 32)
#: the longest chain of dependent root-function evaluations of one block
#: (expansion rounds and Newton-multisection trips) that the kernel's note
#: states for the smoke's test blocks at L = 32, by dtype
CHAIN_BOUND = {torch.float32: 10, torch.float64: 16}


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the kernel: ``threads`` per CTA, ``grid`` CTAs; warp w
    (thread // ``LANES``) projects block w."""
    count: int
    threads: int
    grid: int

    def describe(self) -> str:
        return (f"{self.count} blocks, a warp per block, {self.grid} CTAs "
                f"x {self.threads} threads")


def plan(count: int, kind: str, dtype: torch.dtype, sm_count: int) -> Plan:
    """The launch for ``count`` blocks of ``kind`` in ``dtype`` on a card
    of ``sm_count`` SMs: a warp per block, in the largest CTA that still
    gives every SM a CTA (or every warp one, when there are fewer warps
    than SMs). Every block has one warp, no CTA is empty, and count 0
    launches nothing (grid 0)."""
    if kind not in _KIND or dtype not in _ENTRY:
        raise ValueError(f"cone_proj plan: kind {kind!r}, dtype {dtype}")
    if count < 0 or sm_count < 1:
        raise ValueError(f"cone_proj plan: count {count}, sm_count "
                         f"{sm_count}")
    total = count * LANES
    ctas = min(sm_count, count)  # as many as there are warps
    threads = next((t for t in CTA_THREADS
                    if t <= max(total, 32) and -(-total // t) >= ctas),
                   CTA_THREADS[-1])
    return Plan(count, threads, -(-total // threads))


def _check_args(blocks, kind, alpha):
    if kind not in _KIND:
        raise ValueError(f"cone_proj: kind must be 'exp' or 'pow', "
                         f"got {kind!r}")
    if blocks.dim() != 2 or blocks.shape[1] != 3:
        raise ValueError(f"cone_proj: blocks must be (count, 3), got "
                         f"{tuple(blocks.shape)}")
    if blocks.dtype not in _ENTRY:
        raise TypeError(f"cone_proj: blocks must be f32 or f64, got "
                        f"{blocks.dtype}")
    if isinstance(alpha, torch.Tensor):
        if (alpha.shape != (blocks.shape[0],) or alpha.dtype != blocks.dtype
                or alpha.device != blocks.device):
            raise ValueError("cone_proj: a per-block alpha must be a "
                             "(count,) tensor of the blocks' dtype and "
                             "device")
    elif kind == cones.POW and not 0.0 < float(alpha) < 1.0:
        raise ValueError(f"cone_proj: power-cone alpha must be in (0, 1), "
                         f"got {alpha}")


def cone_proj_plain(blocks: torch.Tensor, kind: str, alpha=0.0,
                    dual: bool = False) -> torch.Tensor:
    """Projection of every (count, 3) block onto the exp or pow cone
    (``dual``: onto its dual, by the Moreau identity x + proj_K(-x)).
    ``alpha``: the power-cone exponent, a float or a (count,) tensor."""
    _check_args(blocks, kind, alpha)
    if kind == cones.EXP:
        proj = cones._proj_exp_blocks
    else:
        def proj(xb):
            return cones._proj_pow_blocks(xb, alpha)
    return blocks + proj(-blocks) if dual else proj(blocks)


def _lib():
    lib = _build.load("cone_proj")
    if not getattr(lib, "_typed", False):
        ptr = ctypes.c_void_p
        for dt, name in _ENTRY.items():
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, _C_REAL[dt], ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        lib.totsu_cone_eval_clocks.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr, ptr, ptr]
        lib.totsu_cone_eval_clocks.restype = ctypes.c_int
        lib._typed = True
    return lib


def device_plan(count: int, kind: str, dtype: torch.dtype,
                device: torch.device) -> Plan:
    """:func:`plan` for the SM count of a CUDA ``device``."""
    return plan(count, kind, dtype,
                torch.cuda.get_device_properties(device).multi_processor_count)


def eval_clocks(kind: str, dtype: torch.dtype, evals: int,
                device: torch.device) -> int:
    """Clocks (``clock64``) of ``evals`` dependent evaluations of the exp
    root function with its derivative (``kind`` 'exp') or of the pow one,
    in one thread on a CUDA ``device``: the latency of one evaluation,
    for the latency floor of a chain. For measurement only."""
    if kind not in _KIND or dtype not in _ENTRY:
        raise ValueError(f"eval_clocks: kind {kind!r}, dtype {dtype}")
    lib = _lib()
    clocks = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.empty(1, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        rc = lib.totsu_cone_eval_clocks(
            _KIND[kind], int(dtype == torch.float64), evals,
            clocks.data_ptr(), sink.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, rc, "cone_proj eval_clocks launch")
    return int(clocks.item())


def cone_proj_cuda(blocks: torch.Tensor, kind: str, alpha=0.0,
                   dual: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only) into a new tensor."""
    global launches
    _check_args(blocks, kind, alpha)
    if blocks.device.type != "cuda":
        raise ValueError("cone_proj_cuda: tensors must be on a CUDA device")
    if not blocks.is_contiguous():
        raise ValueError("cone_proj_cuda: blocks must be contiguous")
    out = torch.empty_like(blocks)
    count = blocks.shape[0]
    if count == 0:
        return out
    per_block = isinstance(alpha, torch.Tensor)
    if per_block and not alpha.is_contiguous():
        raise ValueError("cone_proj_cuda: alpha must be contiguous")
    lib = _lib()
    pl = device_plan(count, kind, blocks.dtype, blocks.device)
    with torch.cuda.device(blocks.device):  # launch on the blocks' card
        rc = getattr(lib, _ENTRY[blocks.dtype])(
            blocks.data_ptr(), out.data_ptr(),
            alpha.data_ptr() if per_block else None,
            0.0 if per_block else float(alpha), count, _KIND[kind],
            int(bool(dual)), pl.threads, pl.grid,
            torch.cuda.current_stream(blocks.device).cuda_stream)
    _build.check(lib, rc, "cone_proj launch")
    launches += 1
    return out


def cone_proj(blocks: torch.Tensor, kind: str, alpha=0.0,
              dual: bool = False) -> torch.Tensor:
    """Project (count, 3) exp or pow blocks: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if blocks.device.type == "cuda":
        return cone_proj_cuda(blocks.contiguous(), kind, alpha, dual)
    if blocks.device.type == "cpu":
        return cone_proj_plain(blocks, kind, alpha, dual)
    raise ValueError(f"cone_proj: unsupported device {blocks.device}")


# ---- a torch model of the kernel's lane-parallel root finder, for the
# tests: the same points, the same ballot rule (the lowest lane), the same
# Newton step, block by block as one group of ``lanes`` runs it
# (cone_exppow.cuh); the trivial cases are the plain version's own


def _col(x):
    return x[:, None] if isinstance(x, torch.Tensor) and x.dim() else x


def _first(pred: torch.Tensor) -> torch.Tensor:
    """Per row, the lowest column where ``pred`` holds; the width if
    none (the ballot and ``__ffs``)."""
    k = pred.shape[1]
    return torch.where(pred, torch.arange(k), k).min(1).values


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _sect_points(lo, hi, lanes: int, in_bits: bool):
    """The multisection points 1..lanes-1 of each bracket (``sect_point``):
    evenly in value, or in the bit pattern of non-negative floats."""
    j = torch.arange(1, lanes)
    if not in_bits:
        frac = j.to(lo.dtype) / lanes
        return _col(lo) + _col(hi - lo) * frac
    it = _BITS[lo.dtype]
    ia = lo.view(it).long()
    d = hi.view(it).long() - ia
    pts = _col(ia) + _col(d // lanes) * j + (_col(d % lanes) * j) // lanes
    return pts.to(it).view(lo.dtype)


def _sect_trips(f, lo, hi, cap: int, lanes: int, dec: bool, in_bits: bool):
    """Newton-multisection trips (``sect_trip``) from the brackets (lo,
    hi) until each block's state stops changing, at most ``cap``; ``f(x,
    grad)`` evaluates the root function at (n,) or (n, k) points. Returns
    the roots and the trips each block took."""
    r = 0.5 * (lo + hi)
    done = torch.zeros(lo.shape, dtype=torch.bool)
    taken = torch.zeros(lo.shape, dtype=torch.long)

    def above(v):  # the root lies above the point
        return v > 0 if dec else v < 0

    for _ in range(cap):
        v, g = f(r, True)
        if lanes > 1:
            x = _sect_points(lo, hi, lanes, in_bits)
            j = _first(~above(f(x, False)))  # lane j + 1; lanes - 1: none
            lo1 = torch.where(j > 0, x.gather(
                1, _col((j - 1).clamp(min=0)))[:, 0], lo)
            hi1 = torch.where(j < lanes - 1, x.gather(
                1, _col(j.clamp(max=lanes - 2)))[:, 0], hi)
        else:
            lo1, hi1 = lo, hi
        inside = (r >= lo1) & (r <= hi1)
        up = above(v)
        lo2 = torch.where(inside & up, r, lo1)
        hi2 = torch.where(inside & ~up, r, hi1)
        nxt = r - v / torch.where(g != 0, g, 1.0)
        ok = torch.isfinite(nxt) & (g != 0) & \
            (((nxt > lo2) & (nxt < hi2)) | ((nxt == r) & inside))
        r2 = torch.where(ok, nxt, 0.5 * (lo2 + hi2))
        taken += ~done
        done |= (lo2 == lo) & (hi2 == hi) & (r2 == r)
        lo, hi, r = lo2, hi2, r2
        if bool(done.all()):
            break
    return r, taken


def _model_exp_root(r0, s0, t0, lanes: int, chains: list):
    expand = cones.EXP_EXPAND_TRIPS
    lo, hi = cones._exp_bracket(r0, s0)
    lo_inf, hi_inf = torch.isinf(lo), torch.isinf(hi)
    # the expansion's points end +- 2^k (k = 0..40; 40 when none of 0..39
    # shows the root), one round per ``lanes`` of them
    end = torch.where(hi_inf, lo, hi)
    step = torch.ldexp(torch.ones(expand + 1, dtype=r0.dtype),
                       torch.arange(expand + 1))
    pts = torch.where(_col(hi_inf), _col(end) + step, _col(end) - step)

    def h(x, grad):
        return cones._exp_h(x, *(_col(u) if x.dim() > 1 else u
                                 for u in (r0, s0, t0)), grad)

    v = h(pts[:, :expand], False)
    k = _first(torch.where(_col(hi_inf), ~(v < 0), ~(v > 0)))
    far = pts.gather(1, _col(k))[:, 0]
    near = torch.where(k > 0, pts.gather(1, _col((k - 1).clamp(min=0)))[:, 0],
                       end)
    lo = torch.where(hi_inf, near, torch.where(lo_inf, far, lo))
    hi = torch.where(lo_inf, near, torch.where(hi_inf, far, hi))
    rounds = torch.where(lo_inf | hi_inf, k.clamp(max=expand - 1) // lanes + 1,
                         0)
    rho, trips = _sect_trips(h, lo, hi, cones.EXP_TRIPS[r0.dtype], lanes,
                             dec=False, in_bits=False)
    chains.append(rounds + trips)
    return cones._exp_from_root(rho, r0, s0, t0)


def _model_pow_root(x0, y0, az, a, lanes: int, chains: list):
    def phi(x, grad):
        if x.dim() > 1:
            return cones._pow_phi(x, _col(x0), _col(y0), _col(az), _col(a),
                                  grad)
        return cones._pow_phi(x, x0, y0, az, a, grad)

    r, trips = _sect_trips(phi, torch.zeros_like(az), az,
                           cones.POW_TRIPS[x0.dtype], lanes, dec=True,
                           in_bits=True)
    chains.append(trips)
    return cones._pow_from_root(r, x0, y0, az, a)


def _lane_model(blocks: torch.Tensor, kind: str, alpha=0.0,
                dual: bool = False, lanes: int = LANES):
    """The kernel's projection of (count, 3) CPU blocks with ``lanes``
    lanes per block, and for each block that needs the root finder (in
    block order) its chain: the dependent evaluations of the root
    function it takes (expansion rounds and Newton-multisection trips)."""
    _check_args(blocks, kind, alpha)
    chains = []
    x = -blocks if dual else blocks
    if kind == cones.EXP:
        out = torch.stack(cones._proj_exp_rst(
            x[:, 0], x[:, 1], x[:, 2],
            root=lambda *a: _model_exp_root(*a, lanes, chains)), 1)
    else:
        out = torch.stack(cones._proj_pow_rst(
            x[:, 0], x[:, 1], x[:, 2], alpha,
            root=lambda *a: _model_pow_root(*a, lanes, chains)), 1)
    return (blocks + out if dual else out,
            torch.cat(chains) if chains else torch.zeros(0, dtype=torch.long))
