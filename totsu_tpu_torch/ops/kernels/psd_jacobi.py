"""Kernel J: the Jacobi PSD-cone projection of packed symmetric blocks.
Wrapper of the CUDA kernel in ``csrc/psd_jacobi.cu``, its launch plan and
its plain PyTorch version.

The JAX package has no Pallas kernel here: XLA compiles the parallel-order
Jacobi eigendecomposition (``totsu_tpu/ops/jacobi.py`` ``jacobi_eigh``,
``psd_part_jacobi``: 10-14 sweeps of k-1 rounds) into one program. Eager
PyTorch would launch about 40 operations per round, thousands per
projection, so on a CUDA tensor :func:`proj_psd_jacobi` projects all
(count, k(k+1)/2) blocks of a factor in one launch, one CTA per block
(:func:`plan`); on a CPU tensor it runs :func:`proj_psd_jacobi_plain`
(``ops/jacobi.py``). A CUDA tensor launches the kernel or raises.
"""

import ctypes
import dataclasses
from typing import Optional

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
#: shared memory a launch may use without ``cudaFuncSetAttribute``
DEFAULT_SMEM = 48 * 1024
#: the largest order the plan takes
MAX_K = 4096


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the kernel: one CTA of ``threads`` per block matrix
    (``count`` CTAs). A (packed, kp(kp+1)/2 values) and V^T (kp^2 values)
    are in shared memory where ``a_smem`` / ``v_smem``, else in a global
    scratch of ``scratch_elems`` values per block; ``smem_bytes`` dynamic
    shared memory, above 48 KB only after ``cudaFuncSetAttribute``
    (``set_attribute``)."""
    k: int
    kp: int
    count: int
    threads: int
    a_smem: bool
    v_smem: bool
    smem_bytes: int
    scratch_elems: int
    set_attribute: bool

    def describe(self) -> str:
        where = {(True, True): "A and V in shared memory",
                 (True, False): "A in shared memory, V in global scratch",
                 (False, False): "A and V in global scratch"}[
                     (self.a_smem, self.v_smem)]
        return (f"k={self.k}: {self.count} CTAs x {self.threads} threads, "
                f"{where}, {self.smem_bytes} B shared"
                + (" (opt-in)" if self.set_attribute else ""))


def smem_bytes(k: int, a_smem: bool, v_smem: bool, elem: int) -> int:
    """Dynamic shared memory of a layout (``psd_jacobi.cu``
    ``smem_bytes``): A and V^T where they are in shared memory, c and s of
    each row, the pairs' rows."""
    kp = k + k % 2
    return (elem * ((sympack.tri_len(kp) if a_smem else 0)
                    + (kp * kp if v_smem else 0) + 2 * kp) + 4 * kp)


def plan(k: int, count: int, dtype: torch.dtype,
         smem_per_block: int) -> Plan:
    """The launch for ``count`` blocks of order ``k`` in ``dtype`` on a
    card whose blocks may use ``smem_per_block`` bytes of shared memory:
    A and V in shared memory when both fit, else A alone (it is read at
    random, V by contiguous rows), else neither; threads enough for the
    kp/2 x kp items of the column update, in whole warps, at most
    ``MAX_THREADS``."""
    if dtype not in _ENTRY:
        raise ValueError(f"psd_jacobi plan: dtype {dtype}")
    if not 1 <= k <= MAX_K or count < 0 or smem_per_block < 1:
        raise ValueError(f"psd_jacobi plan: k {k}, count {count}, "
                         f"smem_per_block {smem_per_block}")
    elem = torch.empty(0, dtype=dtype).element_size()
    kp = k + k % 2
    for a_smem, v_smem in ((True, True), (True, False), (False, False)):
        smem = smem_bytes(k, a_smem, v_smem, elem)
        if smem <= smem_per_block:
            break
    else:
        raise ValueError(f"psd_jacobi plan: k {k} needs {smem} B of shared "
                         f"memory, the card gives {smem_per_block}")
    threads = min(MAX_THREADS, max(32, -(-(kp // 2) * kp // 32) * 32))
    scratch = ((0 if a_smem else sympack.tri_len(kp))
               + (0 if v_smem else kp * kp))
    return Plan(k, kp, count, threads, a_smem, v_smem, smem, scratch,
                smem > DEFAULT_SMEM)


def ops_count(k: int, count: int, sweeps: int) -> int:
    """The operations of one call, counted from the kernel's source (adds,
    multiplies, divides, square roots and compares each 1): per round and
    pair the rotation (14), per pair of pairs P < Q its 2 x 2 block (24;
    21 on P == Q, whose two off-diagonal entries are one), per row and
    pair the column update (6); then max and sqrt of each eigenvalue, the
    k x k scaling of V by them, 2 per term of each output entry of the
    rebuild, and the unpacking and packing one each per entry."""
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
            fn.argtypes = [_C_PTR, _C_PTR, _C_PTR] + [ctypes.c_int] * 7 + [
                ctypes.c_longlong, _C_PTR]
            fn.restype = ctypes.c_int
        lib.totsu_psd_jacobi_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.totsu_psd_jacobi_smem_bytes.restype = ctypes.c_longlong
        lib.totsu_psd_jacobi_smem_optin.argtypes = [ctypes.c_int]
        lib.totsu_psd_jacobi_smem_optin.restype = ctypes.c_int
        if any(lib.totsu_psd_jacobi_smem_bytes(k, a, v, e)
               != smem_bytes(k, bool(a), bool(v), e)
               for k in (1, 8, 49, 256) for a, v in ((1, 1), (1, 0), (0, 0))
               for e in (4, 8)):
            raise RuntimeError("psd_jacobi: shared-memory layout mismatch")
        lib._typed = True
    return lib


_smem_optin = {}  # device index -> bytes a block may opt in to


def device_plan(k: int, count: int, dtype: torch.dtype,
                device: torch.device) -> Plan:
    """:func:`plan` for the shared memory a block may use on a CUDA
    ``device``."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    smem = _smem_optin.get(index)
    if smem is None:
        smem = _lib().totsu_psd_jacobi_smem_optin(index)
        if smem <= 0:
            raise RuntimeError("psd_jacobi: cannot read the card's shared "
                               "memory per block")
        _smem_optin[index] = smem
    return plan(k, count, dtype, smem)


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
    scratch = (torch.empty(count * pl.scratch_elems, dtype=v.dtype,
                           device=v.device) if pl.scratch_elems else None)
    with torch.cuda.device(v.device):  # launch on the blocks' card
        rc = getattr(lib, _ENTRY[v.dtype])(
            v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), k, count,
            n_sweeps, int(bool(scaled)), pl.threads, int(pl.a_smem),
            int(pl.v_smem), pl.smem_bytes,
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
