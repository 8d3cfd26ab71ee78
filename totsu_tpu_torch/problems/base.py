"""ConicProblem: the solver-form problem record produced by all reductions."""

import dataclasses
from typing import Any

import numpy as np
import torch

from totsu_tpu_torch.solver.cone import ConeLayout
from totsu_tpu_torch.solver.conic import solve, solve_jit, SolveResult
from totsu_tpu_torch.solver.operator import LinOp, target_device
from totsu_tpu_torch.solver.params import SolverParam


@dataclasses.dataclass(frozen=True)
class ConicProblem:
    """A conic LP in solver form: min c^T x s.t. A x + s = b, s in K.

    The common output of every Prob* reduction (the analogue of the
    reference's ``problem()`` tuples, e.g. qp.rs:402-436); ``c``, ``b`` and
    the operator's data are tensors on one device.

    ``row_sharding`` (set by
    :func:`totsu_tpu_torch.parallel.shard_dense_problem` and
    ``shard_blocked_ell_problem``) is the split of A's rows over a mesh;
    the solve checks that the operator carries the same one.
    """
    c: torch.Tensor
    a: LinOp
    b: torch.Tensor
    cone: ConeLayout
    row_sharding: Any = None

    @property
    def shape(self):
        return self.a.shape

    def solve(self, param: SolverParam = SolverParam(),
              warm_start=None) -> SolveResult:
        """Solve; raises SolverError on non-convergence."""
        return solve(self.c, self.a, self.b, self.cone, param,
                     warm_start=warm_start, row_sharding=self.row_sharding)

    def solve_jit(self, param: SolverParam = SolverParam(),
                  warm_start=None) -> SolveResult:
        """Solve; returns a status code, never raises on non-convergence."""
        return solve_jit(self.c, self.a, self.b, self.cone, param,
                         warm_start=warm_start,
                         row_sharding=self.row_sharding)


def _device_of(device, *inputs) -> torch.device:
    """Where a builder puts its inputs that are not tensors: ``device``
    when the caller names one, else the device of the first tensor among
    ``inputs``, else the CUDA card (:func:`target_device`)."""
    if device is None:
        for x in inputs:
            if isinstance(x, torch.Tensor):
                return x.device
    return target_device(device)


def _as_tensor(v, device) -> torch.Tensor:
    """Tensors pass through; anything else goes through numpy (Python
    floats become f64, numpy arrays keep their dtype) to ``device``."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(v)).to(device)


def _asvec(v, device, rows=None, like=None):
    """Coerce to a 1-D tensor; None -> zeros(rows) with ``like``'s dtype
    and device."""
    if v is None:
        v = torch.zeros(0 if rows is None else rows, dtype=like.dtype,
                        device=like.device)
    v = _as_tensor(v, device)
    if v.dim() == 2 and v.shape[1] == 1:
        v = v[:, 0]
    if v.dim() != 1:
        raise ValueError(f"expected vector, got shape {tuple(v.shape)}")
    return v


def _asmat(a, device, rows, cols, like):
    """Coerce to a 2-D tensor; None -> zeros((rows, cols)) with ``like``'s
    dtype and device."""
    if a is None:
        a = torch.zeros(rows, cols, dtype=like.dtype, device=like.device)
    a = _as_tensor(a, device)
    if a.dim() != 2:
        raise ValueError(f"expected matrix, got shape {tuple(a.shape)}")
    return a


def _from_matbuild(x):
    """Accept MatBuild / arrays / None uniformly (a MatBuild is host data:
    its numpy array)."""
    from totsu_tpu_torch.problems.matbuild import MatBuild
    if isinstance(x, MatBuild):
        return x.to_dense()
    return x


def _common(*ts):
    """Cast tensors to their promoted dtype (they must share a device)."""
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in ts]
