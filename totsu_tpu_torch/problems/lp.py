"""Linear program -> conic form.

    minimize    c^T x
    subject to  G x <= h   (elementwise)
                A x  = b

Reduction (ref: totsu/src/problem/lp.rs:222-258 doc + 260-338):

    A' = [G; A],  b' = [h; b],  K = R+^m x {0}^p
"""

import torch

from totsu_tpu_torch.problems.base import (
    ConicProblem, _asvec, _asmat, _common, _device_of, _from_matbuild,
)
from totsu_tpu_torch.solver import cone as cones
from totsu_tpu_torch.solver.operator import DenseOp


def lp(c, g=None, h=None, a=None, b=None, *, device=None) -> ConicProblem:
    """LP reduction. ``g``/``h`` inequality, ``a``/``b`` equality
    constraints; any of them may be None/empty. Tensors keep their
    device; other inputs go to ``device``, else to the device of the
    tensors given, else to the CUDA card. Missing blocks take the dtype
    and device of ``c``."""
    dev = _device_of(device, c, g, h, a, b)
    c = _asvec(c, dev)
    n = c.shape[0]
    g = _asmat(g, dev, 0, n, c)
    h = _asvec(h, dev, g.shape[0], c)
    a = _asmat(a, dev, 0, n, c)
    b = _asvec(b, dev, a.shape[0], c)
    m = g.shape[0]
    p = a.shape[0]

    c, g, h, a, b = _common(c, g, h, a, b)
    conic_a = torch.cat([g, a], dim=0).contiguous()
    conic_b = torch.cat([h, b])
    layout = cones.ConeLayout([cones.rpos(m), cones.zero(p)])
    return ConicProblem(c=c, a=DenseOp(conic_a), b=conic_b, cone=layout)


class ProbLP:
    """Reference-style LP wrapper (ref ProbLP, lp.rs:260-338).

    Accepts MatBuild or arrays; ``problem()`` yields the ConicProblem.
    ``device`` as in :func:`lp`.
    """

    def __init__(self, vec_c, mat_g=None, vec_h=None, mat_a=None, vec_b=None,
                 *, device=None):
        self._prob = lp(
            _from_matbuild(vec_c),
            _from_matbuild(mat_g), _from_matbuild(vec_h),
            _from_matbuild(mat_a), _from_matbuild(vec_b), device=device,
        )

    def problem(self) -> ConicProblem:
        return self._prob

    def solve(self, param=None, **kw):
        from totsu_tpu_torch.solver.params import SolverParam
        return self._prob.solve(param or SolverParam(), **kw)
