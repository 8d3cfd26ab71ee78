"""Time the port's fused dual matvec against two torch.mv on the inputs
the main path gives it.

    python3 dm_timing.py [--root DIR] [--cut]

Imports ``totsu_tpu_torch`` from ``DIR`` (default: this script's
directory), so that two trees, for example a commit and its parent
unpacked with ``git archive``, can be timed on one card one after the
other (parent, change, change, parent). Records the last ``dual_matvec``
inputs of 200 host-loop iterations of the n=1000 LP (A 4000 x 1000) and
of the logistic regression (A 7040 x 3040), adds a random 4000 x 1000 A,
all f32, and times the kernel, its plain version and two ``torch.mv`` on
each in turns (``chip_smoke.dm_times``: device microseconds by the
profiler and by CUDA events, and the byte bound). With ``--cut`` it also
builds a copy of ``csrc/dual_matvec.cu`` that returns as soon as each CTA
has stored its partials, without the cross-CTA sums (its p and q are
wrong; its time is that of the stream over A alone), and times it on the
same inputs, which shows what the sums cost. Prints one JSON line with
the card's name and power limit. Needs a CUDA device.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# the statement of csrc/dual_matvec.cu after which each CTA's partials are
# stored and the cross-CTA sums begin
CUT_AT = "  if (gridDim.x == 1) return;\n"


def build_cut(_build):
    """The library of a copy of the source that stops before the cross-CTA
    sums (for timing only)."""
    src = (_build.CSRC / "dual_matvec.cu").read_text()
    if src.count(CUT_AT) != 1:
        raise SystemExit("dm_timing: no single cut point in dual_matvec.cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "dual_matvec-cut.cu"
    cu.write_text(src.replace(CUT_AT, "  return;\n"))
    so = cu.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(so))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cut", action="store_true")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import totsu_tpu_torch as tt
    from totsu_tpu_torch import interop
    from totsu_tpu_torch.ops.kernels import _build
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    if not torch.cuda.is_available():
        raise SystemExit("dm_timing: no CUDA device")
    if not tt.__file__.startswith(root + os.sep):
        raise SystemExit(f"dm_timing: imported {tt.__file__}, not from "
                         f"{root}")
    # this tree's smoke script: its instance generators and timers
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    dev = torch.device("cuda", 0)
    param = tt.SolverParam(accel="halpern", normalize=True, equil_iters=10,
                           check_period=20, eps_acc=1e-3, max_iter=200)
    c1, a1, b1 = cs.make_lp(1000)
    _, _, c4, a4, b4, lr_spec = cs.make_logreg(1000, 20)
    recorded = {}
    real = dm.dual_matvec_cuda

    def recording(a, u, v):
        recorded[tuple(a.shape)] = (a, u.clone(), v.clone())
        return real(a, u, v)

    dm.dual_matvec_cuda = recording
    try:
        for c, a, b, cone in ((c1, a1, b1, tt.ConeLayout([tt.rpos(4000)])),
                              (c4, a4, b4, cs.cone(tt, lr_spec))):
            tt.solve_jit(*interop.problem_from_numpy(
                c, a, b, device=dev, dtype=torch.float32), cone, param)
    finally:
        dm.dual_matvec_cuda = real
    rng = np.random.default_rng(0)
    cases = {"random 4000x1000": tuple(
        torch.from_numpy(x).to(dev, torch.float32)
        for x in (rng.normal(size=(4000, 1000)), rng.normal(size=1000),
                  rng.normal(size=4000)))}
    cases.update({f"recorded {m}x{n}": recorded[(m, n)]
                  for m, n in ((4000, 1000), (7040, 3040))})
    out = {}
    for name, (a, u, v) in cases.items():
        t = cs.dm_times(dm, a, u, v)
        out[name] = {f"{who}_{how}_us": None if x is None else 1e3 * x
                     for how in ("device", "events")
                     for who, x in zip(("kernel", "plain", "library"),
                                       t[how])}
        out[name]["bound_us"] = 1e3 * t["bound"][0]
    if opts.cut:
        lib = _build.load("dual_matvec")
        _build._libs["dual_matvec"] = build_cut(_build)
        try:
            for name, (a, u, v) in cases.items():
                out[name]["kernel_cut_device_us"] = 1e3 * cs.device_ms(
                    lambda: dm.dual_matvec_cuda(a, u, v))
        finally:
            _build._libs["dual_matvec"] = lib
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"root": os.path.relpath(root, HERE), "card": smi,
                      **out}))


if __name__ == "__main__":
    main()
