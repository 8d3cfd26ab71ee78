"""Time the port's blocked exp/pow projection (kernel B) on the inputs the
smoke and the main path give it.

    python3 cp_timing.py [--root DIR]

Imports ``totsu_tpu_torch`` from ``DIR`` (default: this script's
directory), so that two trees, for example a commit and its parent
unpacked with ``git archive``, can be timed on one card one after the
other (parent, change, change, parent). The inputs: phase 2b's of
``chip_smoke.py`` (2000 exp blocks and 2000 pow blocks at alpha
0.1/0.3/0.5/0.9, scales 1e-6..1e6, f32 and f64, primal) and the last
``cone_proj`` inputs of 200 host-loop iterations of the logistic
regression (2000 f32 exp blocks, primal and dual). On each, in turns:
the plain version (wall ms, ended by a synchronize), the kernel twice
(device ms per call by CUDA events behind a sleeping stream,
``chip_smoke.stream_ms``), the plain version again. Beside the times:
the kernel's largest error against the plain version relative to the
block's norm, whether a second call is bitwise equal, the launch plan
(where the tree has one), the reference's trips (total and the longest
chain of one block, ``chip_smoke.cone_proj_trips``) and the operations
bound, and where the tree has them, the lane model's longest chain of
sequential evaluations and the latency of one evaluation by ``clock64``
with the floor they give (an estimate: the chain is the CPU model's, not
counted on the card). Prints one JSON line with the card's name and
power limit. Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def input_sets(cs, tt, interop, cp, dev):
    """name -> (blocks, kind, alpha, dual) on ``dev``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(1)  # phase 2b's inputs
    exp_np = cs.cone_blocks("exp", 2000, rng)
    pow_np = np.concatenate([cs.cone_blocks("pow", 500, rng, al)
                             for al in (0.1, 0.3, 0.5, 0.9)])
    alpha_np = np.repeat([0.1, 0.3, 0.5, 0.9], 500)
    sets = {}
    for dt in (torch.float32, torch.float64):
        tag = str(dt).split(".")[-1]
        sets[f"2b exp {tag}"] = (torch.tensor(exp_np, dtype=dt, device=dev),
                                 "exp", 0.0, False)
        sets[f"2b pow {tag}"] = (torch.tensor(pow_np, dtype=dt, device=dev),
                                 "pow", torch.tensor(alpha_np, dtype=dt,
                                                     device=dev), False)
    recorded = {}
    real = cp.cone_proj_cuda

    def recording(blocks, kind, alpha=0.0, dual=False):
        recorded[dual] = (blocks, kind, alpha, dual)
        return real(blocks, kind, alpha, dual)

    _, _, c, a, b, spec = cs.make_logreg(1000, 20)
    param = tt.SolverParam(accel="halpern", normalize=True, equil_iters=10,
                           check_period=20, eps_acc=1e-3, max_iter=200)
    cp.cone_proj_cuda = recording
    try:
        tt.solve_jit(*interop.problem_from_numpy(
            c, a, b, device=dev, dtype=torch.float32), cs.cone(tt, spec),
            param)
    finally:
        cp.cone_proj_cuda = real
    for dual in (False, True):
        sets[f"logreg {'dual' if dual else 'primal'} f32"] = recorded[dual]
    return sets


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import torch
    import totsu_tpu_torch as tt
    from totsu_tpu_torch import interop
    from totsu_tpu_torch.ops.kernels import cone_proj as cp
    if not torch.cuda.is_available():
        raise SystemExit("cp_timing: no CUDA device")
    if not tt.__file__.startswith(root + os.sep):
        raise SystemExit(f"cp_timing: imported {tt.__file__}, not from "
                         f"{root}")
    # this tree's smoke script: its inputs, timers and counts
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # clocks and ms of one root-finder evaluation, by kind and dtype
    latency = (cs.cone_eval_latency(cp, dev)
               if hasattr(cp, "eval_clocks") else {})
    out = {}
    for name, (xb, kind, al, dual) in input_sets(cs, tt, interop, cp,
                                                 dev).items():
        def kern():
            return cp.cone_proj_cuda(xb, kind, al, dual)

        def plain():
            return cp.cone_proj_plain(xb, kind, al, dual)

        got, again, want = kern(), kern(), plain()
        nrm = torch.linalg.vector_norm(xb.double(), dim=1).clamp(min=1e-300)
        p1 = cs.sync_time(plain, 3)[0]
        k1, k2 = cs.stream_ms(kern), cs.stream_ms(kern)
        p2 = cs.sync_time(plain, 3)[0]
        totals, chain = cs.cone_proj_trips(xb, kind, al, dual)
        ops = cs.cone_proj_ops(xb, kind, al, dual)
        bnd = cs.bound_ms(2 * xb.numel() * xb.element_size(), ops, xb.dtype)
        row = {"blocks": xb.shape[0], "kernel_events_ms": [k1, k2],
               "plain_ms": [1e3 * p1, 1e3 * p2],
               "max_err_rel": float(((got - want).double().abs().amax(1)
                                     / nrm).max()),
               "repeat_bitwise_equal": bool(torch.equal(got, again)),
               "reference_trips": totals, "reference_longest_chain": chain,
               "operations": ops, "bound_ms": bnd[0], "bound_by": bnd[1]}
        if latency:  # the lane-parallel kernel: its plan and chains
            lat = latency[(kind, str(xb.dtype))]
            row["plan"] = cp.device_plan(xb.shape[0], kind, xb.dtype,
                                         dev).describe()
            (row["lane_longest_chain"], _,
             row["model_latency_floor_ms"]) = cs.cone_proj_floor(
                 cp, xb, kind, al, dual, latency)
            row["eval_clocks"] = lat[0]
            row["serial_latency_floor_ms"] = chain * lat[1]
        row["kernel_ms"] = statistics.median(
            [x for x in (k1, k2) if x is not None] or [float("nan")])
        out[name] = row
    print(json.dumps({"root": os.path.relpath(root, HERE), "card": smi,
                      "sm_count": sms, **out}), flush=True)


if __name__ == "__main__":
    main()
