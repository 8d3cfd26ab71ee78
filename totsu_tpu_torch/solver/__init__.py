"""Solver core: params, operators, cones, and the HSDE iteration loop."""

from totsu_tpu_torch.solver.params import SolverParam, SolverStatus, SolverError
from totsu_tpu_torch.solver.conic import solve, solve_jit, SolveResult
from totsu_tpu_torch.solver import cone
from totsu_tpu_torch.solver import operator
