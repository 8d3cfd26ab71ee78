"""Whole-solve pdhg megakernel: wrapper of ``csrc/megakernel.cu`` and its
plain version.

Port of ``totsu_tpu/ops/pallas/megakernel.py`` (``solve_mega``,
``supported``, ``fits``) for the zero, R+, SOC, RSOC, exponential and
power cones with accel '' or 'halpern'. :func:`solve_mega` takes the host loop's post-setup state
(iterated and exact data, preconditioners, seed) and returns its
``(u, v, k, status, crits)`` contract. On a CUDA tensor it runs the whole
loop in one kernel launch or raises; on a CPU tensor it runs
:func:`solve_mega_plain`, which is the port's own host loop
(``solver/conic.py``) called with the same inputs.
"""

import ctypes
import functools

import numpy as np
import torch

from totsu_tpu_torch.ops.kernels import _build
from totsu_tpu_torch.solver.cone import (ConeLayout, ZERO, RPOS, SOC, RSOC,
                                         EXP, POW)

#: kernel launches since the last reset (CUDA only)
launches = 0

#: Envelope of the single-CTA design: one SM streams A from L2 four times
#: per iteration, so A must stay L2-resident (50 MB on an H100 by NVIDIA's
#: data sheet); about half of it is budgeted. Derived from the design, not
#: measured on the H100.
A_BUDGET_BYTES = 24 * 1024 * 1024

_KIND_ZERO, _KIND_RPOS, _KIND_BLOCK, _KIND_EXP, _KIND_POW = 0, 1, 2, 3, 4
#: kind column of the 3-block table (cone_exppow.cuh proj_block)
_TRI_KIND = {EXP: 0, POW: 1}


def supported(cone: ConeLayout) -> bool:
    """True when every cone factor has an in-kernel projection."""
    return all(f.kind in (ZERO, RPOS, SOC, RSOC, EXP, POW)
               for f in cone.factors)


def fits(m: int, n: int, cone: ConeLayout) -> bool:
    """True when A (f32) fits the kernel's L2 budget (the cone adds only
    an m-int kind table and a row of a few ints per block)."""
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


class _MegaArgs(ctypes.Structure):
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "a", "c_it", "b_it", "c_ex", "b_ex", "dptx", "dpty", "dpts",
            "dpsx", "dpsy", "ux0", "uy0", "us0", "vn0", "vm0", "kind",
            "blocks", "tri", "tri_alpha", "ux", "uy", "us", "vn", "vm",
            "scal_out", "int_out", "scratch")]
        + [(name, ctypes.c_int) for name in (
            "m", "n", "nb", "nt", "max_iter", "check_period", "halpern",
            "check_at_start")]
        + [(name, ctypes.c_float) for name in (
            "dptt", "dpst", "norm_b", "norm_c", "ut0", "v10", "sb", "sc",
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
        lib.totsu_mega_struct_size.argtypes = []
        lib.totsu_mega_struct_size.restype = ctypes.c_int
        if lib.totsu_mega_struct_size() != ctypes.sizeof(_MegaArgs):
            raise RuntimeError("megakernel: MegaArgs layout mismatch")
        lib._typed = True
    return lib


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
                          device=a.device)


def _check_inputs(a, vecs, m, n):
    if a.dtype != torch.float32 or a.dim() != 2 or tuple(a.shape) != (m, n):
        raise ValueError("megakernel: A must be an (m, n) f32 tensor")
    for name, t, length in vecs:
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"megakernel: {name} must be f32 on {a.device}")
        if tuple(t.shape) != ((length,) if length is not None else ()):
            raise ValueError(f"megakernel: {name} has shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"megakernel: {name} must be contiguous")
    if not a.is_contiguous():
        raise ValueError("megakernel: A must be contiguous")


def solve_mega_cuda(a, c_it, b_it, c_ex, b_ex, dp_tau, dp_sigma, u0, v0,
                    cone: ConeLayout, *, eps_acc: float, eps_inf: float,
                    eps_zero: float, max_iter: int, check_period: int,
                    relax: float = 1.0, accel: str = "", sb=None, sc=None,
                    check_at_start: bool = False):
    """Launch the whole-solve CUDA kernel (CUDA tensors only)."""
    global launches
    if a.device.type != "cuda":
        raise ValueError("solve_mega_cuda: tensors must be on a CUDA device")
    if accel not in ("", "halpern"):
        raise ValueError(f"megakernel: unsupported accel {accel!r}")
    if not supported(cone):
        raise ValueError("megakernel: unsupported cone layout")
    m, n = a.shape
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
    _check_inputs(a, vecs, m, n)
    dev = a.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    scal = torch.stack([
        dp_tau[3], dp_sigma[2], torch.linalg.vector_norm(b_ex),
        torch.linalg.vector_norm(c_ex), u0[3], v0[2],
        one if sb is None else sb.to(torch.float32),
        one if sc is None else sc.to(torch.float32)]).tolist()
    tables = [torch.tensor(t, device=dev) for t in cone_tables(cone)]
    kind, blocks, tri, tri_alpha = tables

    lib = _lib()
    out = {name: torch.empty(length, dtype=torch.float32, device=dev)
           for name, length in (("ux", n), ("uy", m), ("us", m), ("vn", n),
                                ("vm", m), ("scal_out", 7))}
    int_out = torch.empty(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(int(lib.totsu_mega_workspace_floats(m, n)),
                          dtype=torch.float32, device=dev)
    args = _MegaArgs(
        a=a.data_ptr(), c_it=c_it.data_ptr(), b_it=b_it.data_ptr(),
        c_ex=c_ex.data_ptr(), b_ex=b_ex.data_ptr(),
        dptx=dp_tau[0].data_ptr(), dpty=dp_tau[1].data_ptr(),
        dpts=dp_tau[2].data_ptr(), dpsx=dp_sigma[0].data_ptr(),
        dpsy=dp_sigma[1].data_ptr(), ux0=u0[0].data_ptr(),
        uy0=u0[1].data_ptr(), us0=u0[2].data_ptr(), vn0=v0[0].data_ptr(),
        vm0=v0[1].data_ptr(), kind=kind.data_ptr(),
        blocks=blocks.data_ptr(), tri=tri.data_ptr(),
        tri_alpha=tri_alpha.data_ptr(),
        **{name: t.data_ptr() for name, t in out.items()},
        int_out=int_out.data_ptr(), scratch=scratch.data_ptr(),
        m=m, n=n, nb=blocks.shape[0], nt=tri.shape[0],
        max_iter=int(max_iter),
        check_period=int(check_period), halpern=int(accel == "halpern"),
        check_at_start=int(bool(check_at_start)),
        dptt=scal[0], dpst=scal[1], norm_b=scal[2], norm_c=scal[3],
        ut0=scal[4], v10=scal[5], sb=scal[6], sc=scal[7],
        eps_acc=float(eps_acc), eps_inf=float(eps_inf),
        eps_zero=float(eps_zero), relax=float(relax))
    with torch.cuda.device(dev):  # launch on A's card
        rc = lib.totsu_mega_solve(ctypes.byref(args),
                                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "megakernel launch")
    launches += 1
    k, status = int_out.tolist()
    so = out["scal_out"]
    u = (out["ux"], out["uy"], out["us"], so[0])
    v = (out["vn"], out["vm"], so[1])
    return u, v, k, status, so[2:7]


def solve_mega(a, *args, **kwargs):
    """Run the whole pdhg solve: the CUDA kernel for CUDA tensors, the
    plain version (the host loop) for CPU tensors."""
    if a.device.type == "cuda":
        return solve_mega_cuda(a, *args, **kwargs)
    if a.device.type == "cpu":
        return solve_mega_plain(a, *args, **kwargs)
    raise ValueError(f"megakernel: unsupported device {a.device}")
