"""Build and load the port's CUDA kernels.

Each kernel is one ``totsu_tpu_torch/csrc/<name>.cu`` file with a plain C
interface. At first use it is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/<name>-<hash>.so`` at the repository root, keyed
on a hash of the source, the shared headers (``csrc/*.cuh``) and the flags
(an edited source or header rebuilds), and
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
    """``build/<name>-<hash>.so``: the hash covers the source, every header
    in ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` whose hashed library
    is missing: one nvcc each, all started together, then awaited."""
    with _lock:
        started = {}
        for name in names:
            if name in build_seconds:
                continue
            out = library_path(name)
            if out.exists():
                build_seconds[name] = 0.0
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            started[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in started.items():
            log = proc.communicate()[0]
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
                build_seconds[name] = time.perf_counter() - t0
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, then
    load it (once per process)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point
    (every library exports ``totsu_error_string``)."""
    if rc != 0:
        lib.totsu_error_string.argtypes = [ctypes.c_int]
        lib.totsu_error_string.restype = ctypes.c_char_p
        msg = lib.totsu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
