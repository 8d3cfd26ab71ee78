"""Reference-style Solver facade.

Port of ``totsu_tpu.solver.api``: the ergonomics of the reference's
``Solver::new().par(|p| ...).solve(problem())`` (solver.rs:254-322) on top
of the functional core.
"""

import dataclasses
from typing import Callable, Optional

from totsu_tpu_torch.problems.base import ConicProblem
from totsu_tpu_torch.solver.conic import solve as _solve, SolveResult
from totsu_tpu_torch.solver.params import SolverParam


class _ParamsProxy:
    """Mutable view over SolverParam fields for the par() closure."""

    def __init__(self, param: SolverParam):
        for f in dataclasses.fields(param):
            setattr(self, f.name, getattr(param, f.name))

    def freeze(self) -> SolverParam:
        return SolverParam(**{
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(SolverParam)})


class Solver:
    """``Solver().par(lambda p: ...).solve(prob)`` facade.

    ``solve`` accepts a :class:`ConicProblem` (what ``Prob*.problem()``
    returns) or a ``(c, a, b, cone)`` tuple, and raises
    :class:`SolverError` on non-convergence like the reference. Data that
    is not a tensor goes to ``device`` (default the CUDA card), as in
    :func:`totsu_tpu_torch.solve`.
    """

    def __init__(self, param: Optional[SolverParam] = None):
        self.par_ = param or SolverParam()

    @property
    def param(self) -> SolverParam:
        return self.par_

    def par(self, fn: Callable) -> "Solver":
        proxy = _ParamsProxy(self.par_)
        fn(proxy)
        self.par_ = proxy.freeze()
        return self

    def solve(self, problem, warm_start=None, *, device=None) -> SolveResult:
        if isinstance(problem, ConicProblem):
            c, a, b, cone = problem.c, problem.a, problem.b, problem.cone
        else:
            c, a, b, cone = problem
        return _solve(c, a, b, cone, self.par_, warm_start=warm_start,
                      device=device)
