"""Environment-variable configuration.

Port of ``totsu_tpu.utils.env.set_par_by_env``, after the reference's
``utils2::set_par_by_env`` (examples/utils2/src/set_par_by_env.rs:5-25):
MAX_ITER / EPS_ACC / EPS_INF / EPS_ZERO / LOG_PERIOD override solver
parameters, plus CHECK_PERIOD, EQUIL_ITERS, RELAX, METHOD, PROFILE, ACCEL
and KERNEL.
"""

import dataclasses
import os

from totsu_tpu_torch.solver.params import SolverParam


def set_par_by_env(param: SolverParam) -> SolverParam:
    """Return a copy of ``param`` with env-var overrides applied."""
    updates = {}
    if "MAX_ITER" in os.environ:
        updates["max_iter"] = int(os.environ["MAX_ITER"])
    for name in ("EPS_ACC", "EPS_INF", "EPS_ZERO"):
        if name in os.environ:
            updates[name.lower()] = float(os.environ[name])
    for name in ("LOG_PERIOD", "CHECK_PERIOD", "EQUIL_ITERS"):
        if name in os.environ:
            updates[name.lower()] = int(os.environ[name])
    if "RELAX" in os.environ:
        updates["relax"] = float(os.environ["RELAX"])
    for name in ("METHOD", "PROFILE", "ACCEL", "KERNEL"):
        if name in os.environ:
            updates[name.lower()] = os.environ[name]
    return dataclasses.replace(param, **updates) if updates else param
