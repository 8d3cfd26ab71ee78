"""Problem layer: LP, QP, QCQP, SOCP, SDP and GP reductions to conic form.

Functional reductions (``lp``/``qp``/``qcqp``/``socp``/``sdp``/``gp``)
and the reference-style ``Prob*`` classes. Data that is not a tensor goes
to the CUDA card unless the caller names another device.
"""

from totsu_tpu_torch.problems.base import ConicProblem
from totsu_tpu_torch.problems.matbuild import MatBuild
from totsu_tpu_torch.problems.lp import lp, ProbLP
from totsu_tpu_torch.problems.qp import qp, ProbQP
from totsu_tpu_torch.problems.qcqp import qcqp, ProbQCQP
from totsu_tpu_torch.problems.socp import socp, ProbSOCP
from totsu_tpu_torch.problems.sdp import sdp, ProbSDP
from totsu_tpu_torch.problems.gp import gp

__all__ = [
    "ConicProblem", "MatBuild",
    "lp", "ProbLP", "qp", "ProbQP", "qcqp", "ProbQCQP",
    "socp", "ProbSOCP", "sdp", "ProbSDP", "gp",
]
