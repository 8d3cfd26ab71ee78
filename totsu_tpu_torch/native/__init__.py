"""ctypes bindings of the native C++ reference engine (port of
``totsu_tpu.native``).

``native/totsu_ref.cpp`` is the repository's f64 implementation of the
same embedding and preconditioned Pock-Chambolle iteration, with no
dependency: an independent oracle of the port's iterate path, and of its
exp and pow projections (scalar bisection, independent of the hybrid
root finder that kernel B and the JAX package share). It runs on the
host by nature: data from any device is copied to the host, and the
results are numpy arrays, as in the JAX package.

The library is built at first use with ``g++ -O3 -march=native -shared
-fPIC`` into ``build/totsu_ref-<hash>.so`` at the repository root, keyed
on a hash of the source, the flags and the host's CPU, written to a
temporary file and renamed (``ops/kernels/_build.py`` does the same for the CUDA kernels).
It never writes ``native/libtotsu_ref.so``, which the JAX package's
wrapper rebuilds by modification time.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from totsu_tpu_torch.ops.kernels._build import BUILD_DIR
from totsu_tpu_torch.solver.cone import (ConeLayout, ZERO, RPOS, SOC, RSOC,
                                         PSD, EXP, POW)
from totsu_tpu_torch.solver.params import (SolverParam, SolverStatus,
                                           effective_eps_inf)

_KIND_CODE = {ZERO: 0, RPOS: 1, SOC: 2, RSOC: 3, PSD: 4, EXP: 5, POW: 6}

SOURCE = BUILD_DIR.parent / "native" / "totsu_ref.cpp"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and flags
    (Linux), else the machine's name."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(lines[:2]).encode()
    except OSError:
        return platform.machine().encode()


def library_path():
    """``build/totsu_ref-<hash>.so``, the hash over the source, the flags
    and the host's CPU (``-march=native`` builds for it)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"totsu_ref-{h.hexdigest()[:16]}.so"


def _build():
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build (once per source and flags) and load the engine."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            i32 = ctypes.c_int32
            f64p = ctypes.POINTER(ctypes.c_double)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.totsu_proj_exp.restype = None
            lib.totsu_proj_exp.argtypes = [f64p, ctypes.c_int64]
            lib.totsu_proj_pow.restype = None
            lib.totsu_proj_pow.argtypes = [f64p, ctypes.c_int64,
                                           ctypes.c_double]
            lib.totsu_solve_dense.restype = i32
            lib.totsu_solve_dense.argtypes = [
                i32, i32, f64p, f64p, f64p,
                i32, i32p, i32p, i32p, f64p,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_int64, i32,
                f64p, f64p, ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
    return _lib


def _host(x) -> np.ndarray:
    """A contiguous f64 host copy of a tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64))


def solve_native(c, a, b, cone: ConeLayout,
                 param: SolverParam = SolverParam()
                 ) -> Tuple[np.ndarray, np.ndarray, SolverStatus, int]:
    """Solve on the native engine; returns (x, y, status, iters) with x
    and y f64 numpy arrays. A custom cone raises ``ValueError`` (its
    projection is PyTorch code)."""
    lib = load()
    c = _host(c).ravel()
    a = _host(a)
    b = _host(b).ravel()
    n = c.shape[0]
    m = b.shape[0]
    if a.shape != (m, n):
        raise ValueError(f"A shape {a.shape} != ({m}, {n})")
    if cone.dim != m:
        raise ValueError(f"cone dim {cone.dim} != m {m}")
    for f in cone.factors:
        if f.kind not in _KIND_CODE:
            raise ValueError(
                f"cone kind {f.kind!r} is not supported by the native "
                "engine (user-defined projections run on the port only)")
    kinds = np.asarray([_KIND_CODE[f.kind] for f in cone.factors], np.int32)
    dims = np.asarray([f.dim for f in cone.factors], np.int32)
    counts = np.asarray([f.count for f in cone.factors], np.int32)
    alphas = np.asarray([f.alpha for f in cone.factors], np.float64)

    out_x = np.zeros(n)
    out_y = np.zeros(m)
    out_iters = ctypes.c_int64(0)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    status = lib.totsu_solve_dense(
        n, m,
        c.ctypes.data_as(f64p), a.ctypes.data_as(f64p),
        b.ctypes.data_as(f64p),
        len(cone.factors),
        kinds.ctypes.data_as(i32p), dims.ctypes.data_as(i32p),
        counts.ctypes.data_as(i32p), alphas.ctypes.data_as(f64p),
        param.eps_acc, effective_eps_inf(param, torch.float64),
        param.eps_zero, param.bounded_max_iter, max(1, param.check_period),
        out_x.ctypes.data_as(f64p), out_y.ctypes.data_as(f64p),
        ctypes.byref(out_iters))
    return out_x, out_y, SolverStatus(status), int(out_iters.value)


def _points(points) -> np.ndarray:
    pts = _host(points).copy()
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected (count, 3) points, got {pts.shape}")
    return pts


def proj_exp_native(points) -> np.ndarray:
    """Exp-cone projection of (count, 3) points on the native engine
    (scalar f64 bisection): the projection-level oracle of kernel B."""
    lib = load()
    pts = _points(points)
    lib.totsu_proj_exp(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       pts.shape[0])
    return pts


def proj_pow_native(points, alpha: float) -> np.ndarray:
    """Power-cone projection of (count, 3) points on the native engine."""
    lib = load()
    pts = _points(points)
    lib.totsu_proj_pow(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       pts.shape[0], float(alpha))
    return pts
