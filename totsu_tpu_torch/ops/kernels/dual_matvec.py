"""Fused dual matvec ``(A @ u, A^T @ v)``: wrapper of the CUDA kernel in
``csrc/dual_matvec.cu`` and its plain PyTorch version.

Port of ``totsu_tpu/ops/pallas/dual_matvec.py`` (``dual_matvec_f32``). On
a CUDA tensor :func:`dual_matvec` launches the kernel or raises; on a CPU
tensor it runs :func:`dual_matvec_plain`. A is stored as f32, bf16 or f64;
the vectors and both results are in the accumulation type (f32 for f32
and bf16 storage, f64 for f64).
"""

import ctypes

import torch

from totsu_tpu_torch.ops.kernels import _build

#: kernel launches since the last reset (CUDA only; the plain version
#: does not count)
launches = 0

_ENTRY = {torch.float32: "totsu_dual_matvec_f32",
          torch.bfloat16: "totsu_dual_matvec_bf16",
          torch.float64: "totsu_dual_matvec_f64"}


def acc_dtype(a_dtype: torch.dtype) -> torch.dtype:
    """Accumulation (vector) dtype for a stored-A dtype."""
    if a_dtype not in _ENTRY:
        raise TypeError(f"dual_matvec: A must be f32, bf16 or f64, "
                        f"got {a_dtype}")
    return torch.float64 if a_dtype == torch.float64 else torch.float32


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
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                           ctypes.c_int, ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        lib.totsu_dual_matvec_rows.argtypes = []
        lib.totsu_dual_matvec_rows.restype = ctypes.c_int
        lib._typed = True
    return lib


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
    rows = lib.totsu_dual_matvec_rows()
    q_part = torch.empty(((m + rows - 1) // rows, n), dtype=u.dtype,
                         device=a.device)
    with torch.cuda.device(a.device):  # launch on A's card
        rc = getattr(lib, _ENTRY[a.dtype])(
            a.data_ptr(), u.data_ptr(), v.data_ptr(), p.data_ptr(),
            q.data_ptr(), q_part.data_ptr(), m, n,
            torch.cuda.current_stream(a.device).cuda_stream)
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
