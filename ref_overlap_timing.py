"""Time the host loops of ``chip_smoke.py``'s phases 10 and 16b with and
without the script's CPU-references child running beside them.

    python3 ref_overlap_timing.py [--reps N]

``chip_smoke.py`` starts its f64 CPU references (HiGHS, the SDP, SOCP and
QCQP solves; ``--cpu-references``) in a child process at its start, and
they run for minutes while the card's phases time host-bound loops. This
script measures what the child costs those loops, in three conditions
taken in turns (none, shared, pinned, pinned, shared, none, ``--reps``
times): no child; the child on any core; the child on the last two
cores and this process on the others, as the script runs it. In each it
times, with the child past its start (in HiGHS): phase 10's two
profiled pdhg host loops (the n=1000 LP
and the logistic regression, 200 iterations each: wall and device-busy
us per iteration, launches), 2,000 unprofiled host-loop iterations of
the n=1000 LP, and 200 direct-engine iterations of it under
profile='fast' (set-up included). Prints one line per condition and one
JSON line with the card's name and power limit. Needs a CUDA device.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

import chip_smoke as cs

#: seconds from the child's start to its HiGHS solve (imports, data)
SETTLE_S = 8.0


def measure(tt, lp, lr, p_full, p_fast):
    """The loops' times in the present condition."""
    c1t, a1t, b1t, lp_cone = lp
    p_prof = dataclasses.replace(p_full, max_iter=200)
    out = {}
    for what, prob in (("lp", lp), ("logreg", lr)):
        wall, busy, launches, _ = cs.profile_loop(
            lambda prob=prob: tt.solve_jit(*prob, p_prof), 200)
        out[f"phase10_{what}"] = [wall, busy, launches]
    p_long = dataclasses.replace(p_full, max_iter=2000, eps_acc=1e-12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tt.solve_jit(c1t, a1t, b1t, lp_cone, p_long)
    torch.cuda.synchronize()
    out["lp_2000_us_per_it"] = 1e6 * (time.perf_counter() - t0) / 2000
    p_dr = dataclasses.replace(p_fast, max_iter=200, eps_acc=1e-12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tt.solve_jit(c1t, a1t, b1t, lp_cone, p_dr)
    torch.cuda.synchronize()
    out["direct_200_ms"] = 1e3 * (time.perf_counter() - t0)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=1)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ref_overlap_timing: no CUDA device")
    import totsu_tpu_torch as tt
    from totsu_tpu_torch import interop
    from totsu_tpu_torch.ops.kernels import _build
    from totsu_tpu_torch.ops.kernels import cone_proj as cp
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build({"dual_matvec": dm, "cone_proj": cp})
    f32 = torch.float32
    c1, a1, b1 = cs.make_lp(1000)
    lp = (*interop.problem_from_numpy(c1, a1, b1, device=dev, dtype=f32),
          tt.ConeLayout([tt.rpos(a1.shape[0])]))
    _, _, c4, a4, b4, lr_spec = cs.make_logreg(1000, 20, 0.1)
    lr = (*interop.problem_from_numpy(c4, a4, b4, device=dev, dtype=f32),
          cs.cone(tt, lr_spec))
    p_full = tt.SolverParam(accel="halpern", normalize=True, equil_iters=10,
                            check_period=20, eps_acc=1e-3, max_iter=200_000)
    p_fast = tt.SolverParam(profile="fast", eps_acc=1e-3, max_iter=200_000)
    measure(tt, lp, lr, p_full, p_fast)  # warm up
    cores = sorted(os.sched_getaffinity(0))
    threads = torch.get_num_threads()
    rows = []
    for cond in ("none", "shared", "pinned", "pinned", "shared",
                 "none") * opts.reps:
        child = None
        if cond != "none":
            pin = cond == "pinned"
            child = cs.start_cpu_references(
                cores=cores[-2:] if pin else None, **cs.REF_KW)
            if pin:
                os.sched_setaffinity(0, cores[:-2])
                torch.set_num_threads(min(threads, len(cores) - 2))
            time.sleep(SETTLE_S)
        try:
            row = dict(condition=cond, **measure(tt, lp, lr, p_full,
                                                 p_fast))
            row["child_running"] = child is not None and child.poll() is None
        finally:
            if child is not None:
                cs.stop(child)
            os.sched_setaffinity(0, cores)
            torch.set_num_threads(threads)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": smi, "cores": cores, "rows": rows}))


if __name__ == "__main__":
    main()
