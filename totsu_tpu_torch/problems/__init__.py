"""Problem layer: LP and QP reductions to conic form.

Functional reductions (``lp``/``qp``) and the reference-style ``Prob*``
classes. The QCQP, SOCP, SDP and GP reductions are still to port.
"""

from totsu_tpu_torch.problems.base import ConicProblem
from totsu_tpu_torch.problems.matbuild import MatBuild
from totsu_tpu_torch.problems.lp import lp, ProbLP
from totsu_tpu_torch.problems.qp import qp, ProbQP

__all__ = ["ConicProblem", "MatBuild", "lp", "ProbLP", "qp", "ProbQP"]
