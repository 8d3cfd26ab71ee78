"""Time the port's megakernel on the n=100 benchmark LP and the n=50 QP.

    python3 mega_timing.py [--root DIR] [--reps N]

Imports ``totsu_tpu_torch`` from ``DIR`` (default: this script's
directory), so that two trees, for example a commit and its parent
unpacked with ``git archive``, can be timed on one card one after the other:
run it for each tree in turn (parent, change, change, parent). Solves each
problem once through ``solve(kernel='mega')``, records the megakernel's
inputs, then times ``solve_mega_cuda`` on them: the median wall
milliseconds of ``N`` calls, each ended by a device synchronize (``ms``),
and the kernel time ``torch.profiler`` attributes to a call, the median
over five windows of ``N`` calls (``device_ms``; the wrapper's host work
excluded). Prints one JSON line
with the card's name and power limit. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import torch
    import totsu_tpu_torch as tt
    from totsu_tpu_torch import interop
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    if not torch.cuda.is_available():
        raise SystemExit("mega_timing: no CUDA device")
    if not tt.__file__.startswith(root + os.sep):
        raise SystemExit(f"mega_timing: imported {tt.__file__}, not from "
                         f"{root}")
    sys.path.insert(1, HERE)  # the instance generators of the smoke script
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    param = tt.SolverParam(accel="halpern", normalize=True, equil_iters=10,
                           check_period=20, eps_acc=1e-3, max_iter=200_000,
                           kernel="mega")
    c, a, b = cs.make_lp(100)
    lp = interop.problem_from_numpy(c, a, b, device=dev, dtype=torch.float32)
    lp_cone = tt.ConeLayout([tt.rpos(a.shape[0])])
    qprob = tt.problems.qp(*[torch.from_numpy(x).to(dev)
                             for x in cs.make_qp(50)])
    recorded = []
    real = mk.solve_mega

    def recording(*args, **kwargs):
        recorded.append((args, kwargs))
        return real(*args, **kwargs)

    mk.solve_mega = recording
    try:
        tt.solve(*lp, lp_cone, param)
        qprob.solve(param)
    finally:
        mk.solve_mega = real
    out = {}
    for name, (args, kwargs) in zip(("lp_n100", "qp_n50"), recorded):
        def call():
            return mk.solve_mega_cuda(*args, **kwargs)
        secs, res = cs.sync_time(call, opts.reps)
        out[name] = {"iterations": res[2], "status": res[3],
                     "ms": 1e3 * secs,
                     "device_ms": cs.device_ms(call, opts.reps)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"root": os.path.relpath(root, HERE), "card": smi,
                      "reps": opts.reps, **out}))


if __name__ == "__main__":
    main()
