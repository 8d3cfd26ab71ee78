"""Where the megakernel's time goes: clock64 phase timers in a copy of
the kernel.

    python3 mega_phases.py [--cells a,b,...]

Copies ``totsu_tpu_torch/csrc/megakernel.cu`` into ``build/mega_phases/``
with a timer at each phase boundary of the pdhg update, the grid sums and
the Halpern check (``MARKS``: read by thread 0 of lane 0's CTA 0, accumulated per
phase), builds that copy and solves ``mega_timing.py``'s cells through it.
Prints, per cell, the clocks per iteration of each phase and its share
(time spent waiting at a grid barrier includes the slowest CTA's work
before it). The timers cost a few clocks each; the kernel is otherwise
the repository's. Needs a CUDA device.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

#: (text in megakernel.cu, timer index, the phase that ends there): each
#: timer goes right before its text, which must occur once; a phase is
#: the time since the timer before it
MARKS = (
    ("  pass(cx, z.vn, z.vm, w.p, q_out(cx, w.q));", 0,
     "between updates (Halpern step, loop)"),
    ("  float d[1] = {0.f}, s[1] = {0.f};", 1, "pass 1"),
    ("  grid_sum<1>(cx, w.q, s);\n  block_sum<1>(d, cx.red);\n  float ut_n",
     2, "pass 1's dot products"),
    ("  if (cx.grid == 1) return;", 3, "grid sum: the CTA's sums"),
    ("  float* sred = cx.sred;", 4, "grid sum: barrier"),
    ("    grid_sync(cx);\n    for (int j", 5,
     "grid sum, split: the column slice"),
    ("    for (int j = tid; j < len; j += kThreads) keep(j, __ldcg(sum + j));",
     6, "grid sum, split: barrier 2"),
    ("#pragma unroll\n  for (int k = 0; k < NS; ++k) s[k] = cx.sred[k];", 7,
     "grid sum: read or sum the partials"),
    ("  float ut_n = fmaxf(", 8, "block sum after grid sum 1"),
    ("  // K ru: A rux", 9, "steps and projections"),
    ("  d[0] = 0.f;\n  s[0] = 0.f;", 10, "pass 2"),
    ("  const float rut = ut - 2.f * ut_n;", 11,
     "pass 2's dot products, block sum"),
    ("}\n\n// Termination criteria", 12, "update's last steps"),
    ("      status = check(t, k, w, g, cx, crits, fm);", 13,
     "fixed-point norm"),
    ("      const float dut = t.sc[0] - z.sc[0]", 14, "check"),
)


def patched(src: str) -> str:
    """The kernel source with the timers of MARKS."""
    head = ("__device__ unsigned long long g_phase[32];\n"
            "#define PHASE(k) do { if (threadIdx.x == 0 && blockIdx.x == 0 "
            "&& blockIdx.y == 0)"
            " { const long long t1_ = clock64(); g_phase[k] += t1_ - cx.t0;"
            " cx.t0 = t1_; } } while (0)\n")
    for old, new in (
            ("namespace {\n\nconstexpr int kThreads",
             head + "namespace {\n\nconstexpr int kThreads"),
            ("  float dptt, dpst, norm_b, norm_c, sb, sc;\n};",
             "  float dptt, dpst, norm_b, norm_c, sb, sc;\n"
             "  long long t0;\n};"),
            ("  cx.nt = g.tri_off[cta + 1] - g.tri_off[cta];\n",
             "  cx.nt = g.tri_off[cta + 1] - g.tri_off[cta];\n"
             "  cx.t0 = clock64();\n"),
            ("const char* totsu_error_string(int err) {",
             "int totsu_phases(unsigned long long* out) {\n"
             "  const cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, "
             "sizeof(g_phase));\n"
             "  const unsigned long long zero[32] = {0};\n"
             "  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n"
             "  return static_cast<int>(e);\n}\n\n"
             "const char* totsu_error_string(int err) {")) + tuple(
                (old, f"PHASE({k});\n{old}") for old, k, _ in MARKS):
        if src.count(old) != 1:
            raise SystemExit(f"mega_phases: {old!r} occurs {src.count(old)}"
                             " times in megakernel.cu")
        src = src.replace(old, new)
    return src


def main():
    sys.path.insert(0, HERE)
    import mega_timing
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=",".join(mega_timing.CELLS))
    opts = ap.parse_args()
    import torch
    import totsu_tpu_torch as tt
    from totsu_tpu_torch import interop
    from totsu_tpu_torch.ops.kernels import _build
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    if not torch.cuda.is_available():
        raise SystemExit("mega_phases: no CUDA device")
    import chip_smoke as cs
    out = _build.BUILD_DIR / "mega_phases"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    (out / "megakernel.cu").write_text(
        patched((_build.CSRC / "megakernel.cu").read_text()))
    _build.CSRC = out  # build and load the copy
    lib = mk._lib()
    lib.totsu_phases.argtypes = [ctypes.c_void_p]
    clocks = (ctypes.c_ulonglong * 32)()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    makers = mega_timing.cell_makers(tt, interop, cs, dev)
    for name in opts.cells.split(","):
        args, kwargs = mega_timing.record(mk, makers[name]())
        lib.totsu_phases(ctypes.addressof(clocks))  # zero the timers
        res = mk.solve_mega_cuda(*args, **kwargs)
        torch.cuda.synchronize()
        lib.totsu_phases(ctypes.addressof(clocks))
        total = sum(clocks)
        m, n = args[0].shape
        print(json.dumps({
            "cell": name, "card": smi, "iterations": res[2],
            "plan": mk.device_plan(m, n, args[9], dev)[0].describe(),
            "clocks_per_iteration": total / res[2],
            "phases": {what: [round(clocks[k] / res[2]),
                              round(100 * clocks[k] / total, 1)]
                       for _, k, what in MARKS}}), flush=True)


if __name__ == "__main__":
    main()
