"""Time the port's megakernel on the smoke's megakernel cells.

    python3 mega_timing.py [--root DIR] [--cells a,b,...] [--split 0|1]
                           [--sweep]

Imports ``totsu_tpu_torch`` from ``DIR`` (default: this script's
directory), so that two trees, for example a commit and its parent
unpacked with ``git archive``, can be timed on one card one after the other:
run it for each tree in turn (parent, change, change, parent). The cells
are the n=100 benchmark LP, the n=50 QP, the GP (n=100, A 2001 x 701), the
growth portfolio (S=64, n=50) and the n=1000 benchmark LP (A 4000 x 1000),
all through ``solve(kernel='mega')`` as ``chip_smoke.py`` builds them.
Each is solved once through ``solve`` to record the megakernel's inputs,
then ``solve_mega_cuda`` is timed on them: the median wall milliseconds
of the cell's reps, each ended by a device synchronize (``ms``), and the
kernel time ``torch.profiler`` attributes to a call, the median over the
cell's windows of reps calls (``device_ms``; the wrapper's host work
excluded; null where the profiler lost the kernel's record). The reps per
cell keep a slow tree's large cells (seconds per solve) at one call and
one window. ``--split`` forces the cross-CTA sums'
mode where the tree has a plan (``PLAN_OVERRIDES``). Prints one JSON
line with the card's name and power limit, and each cell's launch plan
where the tree has one. ``--sweep`` (a tree with a plan) instead times
each cell at the grid sizes of ``SWEEP`` in both sum modes, one call each
after a warm-up call, and prints a line per cell: microseconds per
iteration and the plan's modelled microseconds per update, by G and mode
(the data the plan's cost model is fitted to). Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

#: (reps, profiler windows) per cell
CELLS = {"lp_n100": (10, 5), "qp_n50": (10, 5), "gp": (1, 1),
         "growth": (3, 3), "lp_n1000": (1, 1)}
#: grid sizes per cell for --sweep
SWEEP = {"lp_n100": (1, 2, 4, 8, 13, 25), "qp_n50": (1, 2, 4),
         "growth": (1, 2, 5, 7, 10, 20), "gp": (16, 30, 45, 67, 90, 132),
         "lp_n1000": (86, 100, 125, 132)}


def cell_makers(tt, interop, cs, dev):
    """Per cell, a function that builds the problem on ``dev`` and
    returns a solve of it through ``solve(kernel='mega')``."""
    import torch
    f32 = torch.float32
    param = tt.SolverParam(accel="halpern", normalize=True, equil_iters=10,
                           check_period=20, eps_acc=1e-3, max_iter=200_000,
                           kernel="mega")
    tight = tt.SolverParam(accel="halpern", normalize=True, equil_iters=10,
                           check_period=20, eps_acc=1e-4, max_iter=200_000,
                           kernel="mega")

    def lp(n):
        c, a, b = cs.make_lp(n)
        data = interop.problem_from_numpy(c, a, b, device=dev, dtype=f32)
        cone = tt.ConeLayout([tt.rpos(a.shape[0])])
        return lambda: tt.solve(*data, cone, param)

    def qp():
        prob = tt.problems.qp(*[torch.from_numpy(x).to(dev)
                                for x in cs.make_qp(50)])
        return lambda: prob.solve(param)

    def gp():
        prob, _ = tt.problems.gp(*cs.make_gp_terms(), device=dev, dtype=f32)
        return lambda: prob.solve(tight)

    def growth():
        _, c, a, b, spec, _ = cs.make_growth(64, 50, -2.0)
        data = interop.problem_from_numpy(c, a, b, device=dev, dtype=f32)
        cone = cs.cone(tt, spec)
        return lambda: tt.solve(*data, cone, tight)

    return {"lp_n100": lambda: lp(100), "qp_n50": qp, "gp": gp,
            "growth": growth, "lp_n1000": lambda: lp(1000)}


def record(mk, run):
    """The megakernel's inputs of one solve: (args, kwargs)."""
    recorded = []
    real = mk.solve_mega

    def recording(*args, **kwargs):
        recorded.append((args, kwargs))
        return real(*args, **kwargs)

    mk.solve_mega = recording
    try:
        run()
    finally:
        mk.solve_mega = real
    return recorded[0]


def sweep(mk, cs, name, args, kwargs, dev):
    """us per iteration and the modelled us per update of the cell at each
    grid size of SWEEP and both sum modes."""
    m, n = args[0].shape
    out = {}
    try:
        for grid in SWEEP[name]:
            for split in ((False, True) if grid > 1 else (False,)):
                mk.PLAN_OVERRIDES.clear()
                mk.PLAN_OVERRIDES.update(grid=grid, split=split)
                pl = mk.device_plan(m, n, args[9], dev)[0]
                secs, res = cs.sync_time(
                    lambda: mk.solve_mega_cuda(*args, **kwargs), 3)
                out[f"G={pl.grid} {'split' if pl.split else 'replicated'}"] \
                    = {"us_per_iteration": 1e6 * secs / res[2],
                       "iterations": res[2], "status": res[3],
                       "model_us": pl.update_us,
                       "a_in_shared_memory": f"{sum(pl.a_smem)}/{pl.grid}"}
    finally:
        mk.PLAN_OVERRIDES.clear()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--split", type=int, choices=(0, 1), default=None)
    ap.add_argument("--sweep", action="store_true")
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
    cells = opts.cells.split(",")
    unknown = set(cells) - set(CELLS)
    if unknown:
        raise SystemExit(f"mega_timing: unknown cells {sorted(unknown)}")
    if (opts.split is not None or opts.sweep) and not hasattr(
            mk, "PLAN_OVERRIDES"):
        raise SystemExit("mega_timing: the tree has no launch plan")
    if opts.split is not None:
        mk.PLAN_OVERRIDES["split"] = bool(opts.split)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()

    dev = torch.device("cuda", 0)
    makers = cell_makers(tt, interop, cs, dev)
    out = {}
    for name in cells:
        args, kwargs = record(mk, makers[name]())
        if opts.sweep:
            print(json.dumps({"cell": name, "card": smi, "sweep": sweep(
                mk, cs, name, args, kwargs, dev)}), flush=True)
            continue

        def call():
            return mk.solve_mega_cuda(*args, **kwargs)
        reps, windows = CELLS[name]
        secs, res = cs.sync_time(call, reps)
        dev_ms = cs.device_ms(call, reps, windows)
        # one persistent launch: a device time below half the wall means
        # the profiler lost the kernel's record (null)
        out[name] = {"iterations": res[2], "status": res[3],
                     "ms": 1e3 * secs,
                     "device_ms": (dev_ms if dev_ms is not None
                                   and dev_ms >= 0.5e3 * secs else None)}
        if hasattr(mk, "device_plan"):
            m, n = args[0].shape
            out[name]["plan"] = mk.device_plan(m, n, args[9],
                                               dev)[0].describe()
    if not opts.sweep:
        print(json.dumps({"root": os.path.relpath(root, HERE), "card": smi,
                          "split": opts.split, **out}), flush=True)


if __name__ == "__main__":
    main()
