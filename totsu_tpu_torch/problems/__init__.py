"""Problem layer: LP, QP and GP reductions to conic form.

Functional reductions (``lp``/``qp``/``gp``) and the reference-style
``Prob*`` classes. Data that is not a tensor goes to the CUDA card unless
the caller names another device. The QCQP, SOCP and SDP reductions are
still to port.
"""

from totsu_tpu_torch.problems.base import ConicProblem
from totsu_tpu_torch.problems.matbuild import MatBuild
from totsu_tpu_torch.problems.lp import lp, ProbLP
from totsu_tpu_torch.problems.qp import qp, ProbQP
from totsu_tpu_torch.problems.gp import gp

__all__ = ["ConicProblem", "MatBuild", "lp", "ProbLP", "qp", "ProbQP", "gp"]
