"""Where kernel J's time goes: clock64 phase timers in a copy of the
kernel.

    python3 jacobi_phases.py [--shapes K,COUNT ...]

Copies ``totsu_tpu_torch/csrc/psd_jacobi.cu`` into ``build/jacobi_phases/``
with a timer at each phase boundary of a round (``MARKS``: read by thread
0 of CTA 0, accumulated per phase in registers and written out at the
end), builds that copy and runs it at phase
23's shapes of ``chip_smoke.py`` in f32 and f64. Prints, per shape, the
plan, the clocks per round of each phase and its share of the call, the
clocks of the whole call (set-up, rounds, rebuild) and the call's time by
CUDA events (``chip_smoke.stream_ms``), whose ratio is the SM clock the
call ran at. A phase ends where thread 0 of CTA 0 gets past it: the
barrier's share includes the wait for the slowest thread, warp or CTA.
The timers cost a few clocks each; the kernel is otherwise the
repository's. Needs a CUDA device.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

#: (text in psd_jacobi.cu, timer index, the phase that ends there): each
#: timer goes right before its text, which must occur once; a phase is
#: the time since the timer before it
MARKS = (
    ("  int par = 0;  // A's buffer", 0, "set-up (A, V, pivots, barrier)"),
    ("      __syncwarp();\n      const int nxt = par ^ 1;", 1,
     "rotations (every pair, per warp)"),
    ("      // V <- V J on this CTA's rows", 2,
     "blocks of A (update, stores, pivots)"),
    ("      group_sync(SPLIT);\n      par = nxt;", 3, "V update"),
    ("      par = nxt;\n    }\n  }", 4, "the round's barrier"),
    ("  if (C > 1) cluster_sync();  // no CTA leaves", 5, "rebuild"),
)
ROUND = (1, 2, 3, 4)


def patched(src: str) -> str:
    """The kernel source with the timers of MARKS."""
    head = ("__device__ unsigned long long g_phase[8];\n"
            "#define PHASE(k) do { if (threadIdx.x == 0 && blockIdx.x == 0)"
            " { const long long t1_ = clock64(); acc_[k] += t1_ - t0_;"
            " t0_ = t1_; } } while (0)\n")
    for old, new in (
            ("namespace {\n\n// threads per CTA",
             head + "namespace {\n\n// threads per CTA"),
            ("  using VT = typename Vec<T>::type;\n",
             "  using VT = typename Vec<T>::type;\n"
             "  long long t0_ = clock64();\n"
             "  unsigned long long acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"),
            ("cluster_sync();  // no CTA leaves while another reads it\n}",
             "cluster_sync();  // no CTA leaves while another reads it\n"
             "  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
             "    for (int i = 0; i < 8; ++i) g_phase[i] += acc_[i];\n}"),
            ("const char* totsu_error_string(int err) {",
             "int totsu_phases(unsigned long long* out) {\n"
             "  const cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, "
             "sizeof(g_phase));\n"
             "  const unsigned long long zero[8] = {0};\n"
             "  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n"
             "  return static_cast<int>(e);\n}\n\n"
             "const char* totsu_error_string(int err) {")) + tuple(
                (old, f"PHASE({k});\n{old}") for old, k, _ in MARKS):
        if src.count(old) != 1:
            raise SystemExit(f"jacobi_phases: {old!r} occurs "
                             f"{src.count(old)} times in psd_jacobi.cu")
        src = src.replace(old, new)
    return src


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="K,COUNT pairs (default: PHASE23_SHAPES)")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    from totsu_tpu_torch.ops import jacobi
    from totsu_tpu_torch.ops.kernels import _build
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj
    if not torch.cuda.is_available():
        raise SystemExit("jacobi_phases: no CUDA device")
    import chip_smoke as cs
    out = _build.BUILD_DIR / "jacobi_phases"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    (out / "psd_jacobi.cu").write_text(
        patched((_build.CSRC / "psd_jacobi.cu").read_text()))
    _build.CSRC = out  # build and load the copy
    lib = pj._lib()
    lib.totsu_phases.argtypes = [ctypes.c_void_p]
    clocks = (ctypes.c_ulonglong * 8)()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    shapes = (cs.PHASE23_SHAPES if opts.shapes is None else
              [tuple(int(x) for x in s.split(",")) for s in opts.shapes])
    rng = np.random.default_rng(23)
    for k, cnt in shapes:
        for dt in (torch.float32, torch.float64):
            v = torch.tensor(rng.normal(size=(cnt, k * (k + 1) // 2)),
                             dtype=dt, device=dev)
            pj.proj_psd_jacobi_cuda(v)
            torch.cuda.synchronize()
            lib.totsu_phases(ctypes.addressof(clocks))  # zero the timers
            calls = 5
            for _ in range(calls):
                pj.proj_psd_jacobi_cuda(v)
            torch.cuda.synchronize()
            lib.totsu_phases(ctypes.addressof(clocks))
            ms = cs.stream_ms(lambda: pj.proj_psd_jacobi_cuda(v), calls)
            kp = k + k % 2
            rounds = jacobi.sweeps_for(k) * (kp - 1)
            total = sum(clocks) / calls
            print(json.dumps({
                "k": k, "count": cnt, "dtype": str(dt)[6:], "card": smi,
                "plan": pj.device_plan(k, cnt, dt, dev).describe(),
                "rounds": rounds, "clocks_per_call": round(total),
                "clocks_per_round": round(sum(clocks[i] for i in ROUND)
                                          / calls / rounds, 1),
                "ms_events": ms,
                "ghz": None if not ms else round(total / ms / 1e6, 3),
                "phases": {what: [round(clocks[i] / calls / (
                    rounds if i in ROUND else 1), 1),
                    round(100 * clocks[i] / calls / total, 1)]
                    for _, i, what in MARKS}}), flush=True)


if __name__ == "__main__":
    main()
