"""Blocked exp/pow cone projection: wrapper of the CUDA kernel in
``csrc/cone_proj.cu`` and its plain PyTorch version.

The JAX package has no Pallas kernel here: XLA fuses each fixed-trip
Newton-bisection core (``totsu_tpu/solver/cone.py`` ``_proj_exp_blocks``,
``_proj_pow_blocks``) into one kernel. Eager PyTorch would launch each of
its thousands of elementwise operations separately, so on a CUDA tensor
:func:`cone_proj` projects all (count, 3) blocks of a factor in one
launch, one block per thread, with the Moreau dual formed in the kernel;
on a CPU tensor it runs :func:`cone_proj_plain`, the cores of
``solver/cone.py``. The kernel's arithmetic is ``csrc/cone_exppow.cuh``,
which the megakernel shares.
"""

import ctypes

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
                           ctypes.c_int, ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


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
    with torch.cuda.device(blocks.device):  # launch on the blocks' card
        rc = getattr(lib, _ENTRY[blocks.dtype])(
            blocks.data_ptr(), out.data_ptr(),
            alpha.data_ptr() if per_block else None,
            0.0 if per_block else float(alpha), count, _KIND[kind],
            int(bool(dual)),
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
