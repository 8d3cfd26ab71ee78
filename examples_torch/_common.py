"""Shared example helpers: device and dtype selection, result lines."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def setup(cpu: bool = None):
    """(device, dtype, name). ``--cpu`` (or ``TOTSU_CPU=1``, or
    ``cpu=True``) runs on the CPU in f64, like the reference's
    FloatGeneric/LAPACK backends; the default is the CUDA card in f32,
    and without a card that raises (the port never falls back to the
    CPU on its own)."""
    import torch
    if cpu is None:
        cpu = "--cpu" in sys.argv or os.environ.get("TOTSU_CPU") == "1"
    if cpu:
        return torch.device("cpu"), torch.float64, "cpu-f64"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run the example with --cpu")
    return torch.device("cuda"), torch.float32, "cuda-f32"


def report(name, res, t_solve, extra=""):
    status = ["RUNNING", "CONVERGED", "EXCESS_ITER", "UNBOUNDED",
              "INFEASIBLE"][int(res.status)]
    print(f"[{name}] {status} iters={int(res.iters)} "
          f"cri=({float(res.cri_pri):.2e},{float(res.cri_dual):.2e},"
          f"{float(res.cri_gap):.2e}) solve={t_solve:.3f}s {extra}")
    return status
