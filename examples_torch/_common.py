"""Shared example helpers: device and dtype selection, result lines."""

import os
import sys

import numpy as np

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


def tensors(device, dtype, *arrays):
    """Numpy data as ``dtype`` tensors on ``device`` (lists of arrays as
    lists of tensors)."""
    import torch

    def one(x):
        if isinstance(x, (list, tuple)):
            return [one(v) for v in x]
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return tuple(one(x) for x in arrays)


def host(t):
    """A tensor's values as an f64 numpy array."""
    return t.detach().double().cpu().numpy()


def layout(spec):
    """The port's ConeLayout of a (factor name, args) spec, as the
    builders return it: ``[("rpos", (m,)), ("expc", (k,))]``."""
    import totsu_tpu_torch as tt
    return tt.ConeLayout([getattr(tt, kind)(*args) for kind, args in spec])


def param(dtype, **kw):
    """The example's SolverParam (through ``set_par_by_env``). In f32
    (the card) ``kernel='auto'``, so that a problem inside the
    megakernel's envelope runs on it (on the CPU the host loop runs
    either way), and ``f32`` overrides the f64 settings: eps_acc below
    about 1e-4 is out of f32's reach."""
    import torch
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.utils import set_par_by_env
    f32 = kw.pop("f32", {})
    if dtype == torch.float32:
        kw = {"kernel": "auto", **kw, **f32}
    return set_par_by_env(tt.SolverParam(**kw))
