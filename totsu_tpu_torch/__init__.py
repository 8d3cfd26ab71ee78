"""totsu_tpu_torch — the conic solver on PyTorch and CUDA (NVIDIA Hopper).

A port of ``totsu_tpu`` that keeps its module names and public names: the
homogeneous self-dual embedding of a conic LP

    minimize    c^T x
    subject to  A x + s = b,   s in K

iterated with the diagonally preconditioned Pock-Chambolle method on a
dense or structured ``A`` (stacks, diagonal, sparse, blocked-ELL,
matrix-free), over products of zero / nonnegative / second-order /
rotated-second-order / exponential / power / PSD cones and user-defined
(custom) cones, with the LP, QP, QCQP, SOCP, SDP and GP reductions. Plain
tensor code is PyTorch; the kernels of the path are CUDA C++ for
``sm_90a`` (``csrc/``):

  * ``dual_matvec`` — the fused {A u, A^T v} pair of every update and check;
  * ``cone_proj``   — the blocked exp / pow cone projection of the host loop;
  * ``megakernel``  — the whole pdhg solve in one launch (``kernel='mega'``);
  * ``psd_jacobi``  — the Jacobi PSD projection (``psd(k, method='jacobi')``),
    one CTA per block.

Tensors carry their device: a solve runs where its data lies. Data that
is not a tensor yet (numpy, lists) goes to the CUDA card unless the caller
passes ``device=``; without a card that raises. On a CPU tensor each
kernel wrapper runs its plain PyTorch version instead.

Besides pdhg (plain, Halpern and restarted averaging), ``method='direct'``
runs the direct engine (Douglas-Rachford on the embedding, plain or
Halpern: a cached solve of I + A^T A for a dense A, warm-started Jacobi
CG for any other operator), and ``profile='fast'`` routes a problem as
the JAX package does. Every engine checkpoints
(``return_state``, a :class:`ResumeState`) and resumes exactly
(``resume_state``); ``solve(chunk_iters=N)`` chains such calls, and
``log_period`` prints the host loops' progress. ``solve(...,
polish=True)`` refines a converged solution on the host in f64
(``solver/polish.py``), and :func:`make_differentiable_solver`
(``diff.py``) differentiates through a solve in reverse and forward mode,
with the cone projections' derivatives in closed form
(``solver/dproj.py``).

Many programs of one layout solve in lockstep: :func:`solve_batch`
(``parallel/batch.py``, each lane its own status, chunked or whole; the
direct engine or pdhg; a dense A, or structured lanes stacked with
:meth:`BatchedOp.stack`), :class:`BatchRunner` (``runtime/batcher.py``,
bucketed microbatches and an asynchronous ``submit``) and
:func:`consensus_admm` (``parallel/admm.py``).

Distribution runs one process per device over ``torch.distributed``
(``parallel``: ``multihost.init``, ``make_mesh``): a problem's rows split
over a mesh's ``row`` axis (``shard_dense_problem``,
``shard_blocked_ell_problem``, with the collectives inside the operator),
a batch's lanes or ADMM's agents over its ``batch`` axis.
``totsu_tpu_torch.native`` wraps the C++ reference engine
(``native/totsu_ref.cpp``) on the host.
"""

from totsu_tpu_torch.solver.params import SolverParam, SolverStatus, SolverError
from totsu_tpu_torch.solver.api import Solver
from totsu_tpu_torch.solver.conic import (solve, solve_jit, solve_sequence,
                                          SolveResult, ResumeState)
from totsu_tpu_torch.solver.cone import (
    ConeLayout, zero, rpos, soc, rsoc, psd, expc, powc, custom,
)
from totsu_tpu_torch.solver.operator import (
    LinOp, DenseOp, BatchedDenseOp, BatchedOp, DiagOp, SparseOp, BlockedEllOp, ZeroOp, CustomOp, VStackOp,
    HStackOp, BlockOp, ScaledOp, as_linop,
)
from totsu_tpu_torch.problems import (
    ConicProblem, ProbLP, ProbQP, ProbQCQP, ProbSOCP, ProbSDP, MatBuild,
)
from totsu_tpu_torch.diff import make_differentiable_solver
from totsu_tpu_torch.parallel import solve_batch, consensus_admm, AdmmResult
from totsu_tpu_torch.runtime import BatchRunner

__version__ = "0.1.0"

__all__ = [
    "SolverParam", "SolverStatus", "SolverError", "Solver",
    "solve", "solve_jit", "solve_sequence", "SolveResult", "ResumeState",
    "ConeLayout", "zero", "rpos", "soc", "rsoc", "psd", "expc", "powc", "custom",
    "LinOp", "DenseOp", "BatchedDenseOp", "BatchedOp", "DiagOp", "SparseOp", "BlockedEllOp", "ZeroOp", "CustomOp",
    "VStackOp", "HStackOp",
    "BlockOp", "ScaledOp", "as_linop",
    "ConicProblem", "ProbLP", "ProbQP", "ProbQCQP", "ProbSOCP", "ProbSDP",
    "MatBuild", "make_differentiable_solver", "solve_batch",
    "consensus_admm", "AdmmResult", "BatchRunner",
]
