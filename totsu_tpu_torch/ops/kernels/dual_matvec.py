"""Fused dual matvec ``(A @ u, A^T @ v)``: wrapper of the CUDA kernel in
``csrc/dual_matvec.cu`` and its plain PyTorch version.

Port of ``totsu_tpu/ops/pallas/dual_matvec.py`` (``dual_matvec_f32``). On
a CUDA tensor :func:`dual_matvec` launches the kernel or raises; on a CPU
tensor it runs :func:`dual_matvec_plain`. A is stored as f32, bf16 or f64;
the vectors and both results are in the accumulation type (f32 for f32
and bf16 storage, f64 for f64).

The launch is planned here, by the pure function :func:`plan`: the grid of
row groups x column chunks, the reduction groups of the cross-CTA sums and
the scratch they need. The kernel takes the plan as it is.
"""

import ctypes
import dataclasses
import functools
import math

import torch

from totsu_tpu_torch.ops.kernels import _build

#: kernel launches since the last reset (CUDA only; the plain version
#: does not count)
launches = 0

_ENTRY = {torch.float32: "totsu_dual_matvec_f32",
          torch.bfloat16: "totsu_dual_matvec_bf16",
          torch.float64: "totsu_dual_matvec_f64"}

#: threads (16-byte loads) per column chunk at most; the kernel's
#: ``kMaxThreads``
MAX_THREADS = 512
#: rows of A per row group at most (the kernel's ``kMaxRows``) and at least
MAX_ROWS = 128
MIN_ROWS = 8
#: CTAs of the grid per SM: one wave, each SM one CTA
CTAS_PER_SM = 1


def acc_dtype(a_dtype: torch.dtype) -> torch.dtype:
    """Accumulation (vector) dtype for a stored-A dtype."""
    if a_dtype not in _ENTRY:
        raise TypeError(f"dual_matvec: A must be f32, bf16 or f64, "
                        f"got {a_dtype}")
    return torch.float64 if a_dtype == torch.float64 else torch.float32


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the kernel (the fields of its ``Plan`` struct).

    CTA ``g * col_chunks + s`` reads rows ``rows(g)`` and columns
    ``cols(s)`` of A. Its partial of q (over its rows) goes to row ``g`` of
    ``q_part`` when ``row_groups > 1``, its partial of p (over its columns)
    to row ``s`` of ``p_part`` when ``col_chunks > 1``. Row groups are
    summed in reduction groups of ``group_size``, in index order, then the
    groups' sums (``q_grp``) in index order.
    """
    m: int
    n: int
    vec: int          # elements of A per load
    nvec: int         # loads per row
    threads: int      # threads per CTA
    row_groups: int
    col_chunks: int
    chunk_vecs: int   # loads per row of a column chunk
    group_size: int   # row groups per reduction group
    groups: int       # reduction groups

    @property
    def grid(self) -> int:
        return self.row_groups * self.col_chunks

    def rows(self, g: int) -> range:
        """Rows of A in row group ``g`` (balanced to one row)."""
        return range(g * self.m // self.row_groups,
                     (g + 1) * self.m // self.row_groups)

    def cols(self, s: int) -> range:
        """Columns of A in column chunk ``s``."""
        return range(s * self.chunk_vecs * self.vec,
                     min(self.nvec, (s + 1) * self.chunk_vecs) * self.vec)

    def group(self, k: int) -> range:
        """Row groups of reduction group ``k``."""
        return range(k * self.group_size,
                     min(self.row_groups, (k + 1) * self.group_size))

    @property
    def q_part_len(self) -> int:
        return self.row_groups * self.n if self.row_groups > 1 else 0

    @property
    def q_grp_len(self) -> int:
        return self.groups * self.n if self.groups > 1 else 0

    @property
    def p_part_len(self) -> int:
        return self.col_chunks * self.m if self.col_chunks > 1 else 0

    @property
    def scratch_len(self) -> int:
        """Accumulator values of scratch: q_part, q_grp, p_part in turn."""
        return self.q_part_len + self.q_grp_len + self.p_part_len

    @property
    def counters(self) -> int:
        """Ticket counters: one per reduction group and one for the last
        group (none for a single CTA)."""
        return self.groups + 1 if self.grid > 1 else 0


@functools.lru_cache(maxsize=64)
def plan(m: int, n: int, dtype: torch.dtype, sm_count: int,
         aligned: bool = True) -> Plan:
    """The launch for an (m, n) A of ``dtype`` on a card of ``sm_count``
    SMs. ``aligned`` says A's base address is a multiple of 16 bytes; the
    16-byte loads need that and n a multiple of the vector width, else a
    load is one element."""
    if m < 1 or n < 1 or sm_count < 1:
        raise ValueError(f"dual_matvec plan: m={m}, n={n}, sm={sm_count}")
    width = 16 // dtype.itemsize
    vec = width if aligned and n % width == 0 else 1
    nvec = n // vec
    col_chunks = -(-nvec // MAX_THREADS)
    chunk_vecs = -(-nvec // col_chunks)
    row_groups = max(1, -(-m // MAX_ROWS),
                     min(sm_count * CTAS_PER_SM // col_chunks, m // MIN_ROWS))
    group_size = math.isqrt(row_groups - 1) + 1  # ceil(sqrt(G))
    return Plan(m=m, n=n, vec=vec, nvec=nvec,
                threads=32 * -(-chunk_vecs // 32), row_groups=row_groups,
                col_chunks=col_chunks, chunk_vecs=chunk_vecs,
                group_size=group_size, groups=-(-row_groups // group_size))


class _PlanArgs(ctypes.Structure):
    _fields_ = [(f.name, ctypes.c_int) for f in dataclasses.fields(Plan)]


@functools.lru_cache(maxsize=64)
def _plan_args(pl: Plan) -> _PlanArgs:
    return _PlanArgs(**dataclasses.asdict(pl))


def _check_args(a, u, v):
    if a.dim() != 2 or u.dim() != 1 or v.dim() != 1:
        raise ValueError("dual_matvec: expects A (m, n), u (n,), v (m,)")
    m, n = a.shape
    if u.shape[0] != n or v.shape[0] != m:
        raise ValueError(f"dual_matvec: A {tuple(a.shape)} with u "
                         f"{tuple(u.shape)} and v {tuple(v.shape)}")
    acc = acc_dtype(a.dtype)
    if u.dtype != acc or v.dtype != acc:
        raise TypeError(f"dual_matvec: A {a.dtype} needs {acc} vectors, "
                        f"got {u.dtype} and {v.dtype}")
    if not (u.device == v.device == a.device):
        raise ValueError("dual_matvec: A, u and v must share a device")


def dual_matvec_plain(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Unfused PyTorch version (two products, bf16 widened first)."""
    _check_args(a, u, v)
    af = a.to(u.dtype) if a.dtype == torch.bfloat16 else a
    return af @ u, v @ af


def _lib():
    lib = _build.load("dual_matvec")
    if not getattr(lib, "_typed", False):
        ptr = ctypes.c_void_p
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 7 + [ctypes.POINTER(_PlanArgs), ptr]
            fn.restype = ctypes.c_int
        for name in ("totsu_dual_matvec_plan_size",
                     "totsu_dual_matvec_max_threads",
                     "totsu_dual_matvec_max_rows"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if (lib.totsu_dual_matvec_plan_size() != ctypes.sizeof(_PlanArgs)
                or lib.totsu_dual_matvec_max_threads() != MAX_THREADS
                or lib.totsu_dual_matvec_max_rows() != MAX_ROWS):
            raise RuntimeError("dual_matvec: Plan layout mismatch")
        lib._typed = True
    return lib


_sm_counts = {}
_counters = {}  # (device, stream) -> int32 tickets, left at 0 by the kernel


def _ticket_counters(device, stream, count):
    key = (device, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 256), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def dual_matvec_cuda(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Launch the CUDA kernel (CUDA tensors only)."""
    global launches
    _check_args(a, u, v)
    if a.device.type != "cuda":
        raise ValueError("dual_matvec_cuda: tensors must be on a CUDA device")
    if not (a.is_contiguous() and u.is_contiguous() and v.is_contiguous()):
        raise ValueError("dual_matvec_cuda: A, u and v must be contiguous")
    m, n = a.shape
    p = torch.empty(m, dtype=u.dtype, device=a.device)
    q = torch.empty(n, dtype=u.dtype, device=a.device)
    if m == 0 or n == 0:
        return p.zero_(), q.zero_()
    lib = _lib()
    sm = _sm_counts.get(a.device)
    if sm is None:
        sm = _sm_counts[a.device] = torch.cuda.get_device_properties(
            a.device).multi_processor_count
    pl = plan(m, n, a.dtype, sm, aligned=a.data_ptr() % 16 == 0)
    scratch = torch.empty(pl.scratch_len, dtype=u.dtype, device=a.device)
    with torch.cuda.device(a.device):  # launch on A's card
        stream = torch.cuda.current_stream(a.device)
        counters = _ticket_counters(a.device, stream, pl.counters)
        rc = getattr(lib, _ENTRY[a.dtype])(
            a.data_ptr(), u.data_ptr(), v.data_ptr(), p.data_ptr(),
            q.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
            ctypes.byref(_plan_args(pl)),
            stream.cuda_stream)
    _build.check(lib, rc, "dual_matvec launch")
    launches += 1
    return p, q


def dual_matvec(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(A @ u, A^T @ v): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if a.device.type == "cuda":
        return dual_matvec_cuda(a, u, v)
    if a.device.type == "cpu":
        return dual_matvec_plain(a, u, v)
    raise ValueError(f"dual_matvec: unsupported device {a.device}")
