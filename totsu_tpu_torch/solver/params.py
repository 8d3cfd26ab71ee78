"""Solver parameters, status codes and errors.

Port of ``totsu_tpu.solver.params``: the same fields with the same
defaults and meaning, so a parameter set carries across field by field
(``totsu_tpu_torch.interop.param_from_reference``). ``cg_precond``
belongs to the indirect engine (``method='direct'`` on a structured
operator) and has no effect on the dense engines.
"""

import dataclasses
import enum
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SolverParam:
    """First-order solver parameters.

    Defaults match the reference (solver.rs:27-41) except ``max_iter``,
    which the reference leaves unbounded (``None``); ``None`` maps to 10**7
    so the excess-iteration status stays well-defined.
    """
    max_iter: Optional[int] = None
    eps_acc: float = 1e-6
    #: Certificate tolerance; ``None`` resolves to 1e-6 with the dtype floor
    #: of :func:`effective_eps_inf`, an explicit value is honored verbatim.
    eps_inf: Optional[float] = None
    eps_zero: float = 1e-12
    #: Progress logging period: 0 = off; else the pdhg host loops print a
    #: line on every check past each multiple of it (the megakernel and
    #: the direct engine print nothing).
    log_period: int = 0
    #: Run the termination test every this many iterations.
    check_period: int = 1
    #: Over-relaxation factor rho in (0, 2) for the primal-dual step.
    relax: float = 1.0
    #: Ruiz-equilibration sweeps (``None`` = unset/off, ``0`` = explicitly off).
    equil_iters: Optional[int] = None
    #: Iteration engine: 'pdhg' (the reference's Pock-Chambolle method) or
    #: 'direct' (Douglas-Rachford on the embedding: a cached solve of
    #: I + A^T A for a dense A, warm-started CG for any other operator).
    method: str = "pdhg"
    #: Acceleration: '' (reference iterate path), 'halpern' (restarted
    #: reflected Halpern; pdhg and direct) or 'restart' (PDLP-style
    #: restarted averaging; pdhg host loop only).
    accel: str = ""
    #: b/c norm normalization; ``None`` = engine default (off for pdhg, on
    #: for direct).
    normalize: Optional[bool] = None
    #: Return the iteration state as ``SolveResult.state`` (a
    #: ``ResumeState`` that ``resume_state`` continues exactly).
    return_state: bool = False
    #: Storage dtype of A inside the update matvecs (e.g. 'bfloat16');
    #: the criteria keep the full-precision A.
    matvec_dtype: Optional[str] = None
    #: 'reference' (default) or 'fast': every field still at its default
    #: gets the JAX package's fast setting. Dense A inside the megakernel's
    #: envelope on the card (n <= 300; n <= 200 with RSOC blocks; never
    #: with exp/pow blocks) stays on pdhg with Halpern and kernel='auto';
    #: other dense A with n <= 8192 takes method='direct' with Halpern;
    #: the rest pdhg with Halpern, normalize and Ruiz. The crossovers are
    #: TPU measurements, unmeasured on the H100.
    profile: str = "reference"
    #: Indirect-engine CG preconditioner: 'auto' (Jacobi, diag(I + A^T A),
    #: where the operator has col_sqsum, else plain CG), 'jacobi' (raises
    #: without col_sqsum) or 'none'.
    cg_precond: str = "auto"
    #: Iteration-loop backend: '' = host loop, 'mega' = the whole-solve
    #: CUDA kernel (its plain version on CPU tensors), 'auto' = the kernel
    #: on a CUDA device when the problem is inside its envelope.
    kernel: str = ""

    @property
    def bounded_max_iter(self) -> int:
        return 10_000_000 if self.max_iter is None else self.max_iter


def effective_eps_inf(param: SolverParam, dtype: torch.dtype) -> float:
    """Certificate tolerance the engine actually uses: ``eps_inf`` when set,
    else 1e-6 floored at 100 machine epsilons of ``dtype`` (capped at 1e-4);
    no effect in f64."""
    if param.eps_inf is not None:
        return param.eps_inf
    return max(1e-6, min(100.0 * float(torch.finfo(dtype).eps), 1e-4))


class SolverStatus(enum.IntEnum):
    """Status code carried through the solve loop."""
    RUNNING = 0
    CONVERGED = 1
    EXCESS_ITER = 2
    UNBOUNDED = 3
    INFEASIBLE = 4


class SolverError(Exception):
    """Raised by the host-facing ``solve`` for non-converged results."""

    def __init__(self, status: SolverStatus):
        self.status = SolverStatus(status)
        super().__init__(self.status.name)


def status_name(code: int) -> str:
    return SolverStatus(int(code)).name
