"""Build and load the port's CUDA kernels.

Each kernel is one ``totsu_tpu_torch/csrc/<name>.cu`` file with a plain C
interface. At first use it is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/<name>-<hash>.so`` at the repository root, keyed
on a hash of the source and the flags (an edited source rebuilds), and
loaded with ``ctypes``. Nothing is built when a module is imported, and a
failed build raises: no caller falls back to a plain version.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
#: seconds each library took to build in this process (0.0 = cached .so)
build_seconds = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, then
    load it (once per process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        t0 = time.perf_counter()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, out)
        build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point
    (every library exports ``totsu_error_string``)."""
    if rc != 0:
        lib.totsu_error_string.argtypes = [ctypes.c_int]
        lib.totsu_error_string.restype = ctypes.c_char_p
        msg = lib.totsu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
