"""Quadratic program -> conic form via epigraph + rotated-SOC embedding.

    minimize    (1/2) x^T P x + q^T x + r
    subject to  G x <= h
                A x  = b

Reduction (ref: totsu/src/problem/qp.rs:299-342 doc; operators 9-256):
introduce the epigraph variable t, minimize t subject to

    [ 0      0 ]            [ 1 ]
    [ q^T   -1 ] [x]        [ 0 ]
    [ -P^1/2 0 ] [t]  + s = [ 0 ]     s in Qr^(2+n) x R+^m x {0}^p
    [ G      0 ]            [ h ]
    [ A      0 ]            [ b ]

P^(1/2) is computed once at build time by eigendecomposition
(ref qp.rs:386 -> MatBuild::set_sqrt).
"""

import torch

from totsu_tpu_torch.ops import sympack
from totsu_tpu_torch.problems.base import (
    ConicProblem, _as_tensor, _asvec, _asmat, _common, _device_of,
    _from_matbuild,
)
from totsu_tpu_torch.solver import cone as cones
from totsu_tpu_torch.solver.operator import DenseOp


def qp(p_mat, q, g=None, h=None, a=None, b=None, *,
       device=None) -> ConicProblem:
    """QP reduction. ``p_mat`` is the dense symmetric PSD objective matrix
    (n, n). Tensors keep their device; other inputs go to ``device``,
    else to the device of the tensors given, else to the CUDA card.
    Missing blocks take the dtype and device of ``q``."""
    dev = _device_of(device, p_mat, q, g, h, a, b)
    q = _asvec(q, dev)
    n = q.shape[0]
    p_mat = _as_tensor(p_mat, dev)
    g = _asmat(g, dev, 0, n, q)
    h = _asvec(h, dev, g.shape[0], q)
    a = _asmat(a, dev, 0, n, q)
    b = _asvec(b, dev, a.shape[0], q)
    m = g.shape[0]
    p = a.shape[0]

    q, p_mat, g, h, a, b = _common(q, p_mat, g, h, a, b)
    p_sqrt = sympack.psd_sqrt(p_mat)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=q.dtype, device=q.device)

    z_col = zeros(n, 1)
    conic_a = torch.cat([
        zeros(1, n + 1),
        torch.cat([q[None, :], -torch.ones_like(z_col[:1])], dim=1),
        torch.cat([-p_sqrt, z_col], dim=1),
        torch.cat([g, zeros(m, 1)], dim=1),
        torch.cat([a, zeros(p, 1)], dim=1),
    ], dim=0).contiguous()
    conic_b = torch.cat([torch.ones_like(q[:1]), zeros(1 + n), h, b])
    conic_c = zeros(n + 1)
    conic_c[n] = 1.0

    layout = cones.ConeLayout(
        [cones.rsoc(2 + n), cones.rpos(m), cones.zero(p)])
    return ConicProblem(c=conic_c, a=DenseOp(conic_a), b=conic_b, cone=layout)


class ProbQP:
    """Reference-style QP wrapper (ref ProbQP, qp.rs:343-437).

    ``sym_p`` may be a SymPack MatBuild or a dense symmetric array.
    The solution's first n entries are x (the last is the epigraph t).
    ``device`` as in :func:`qp`.
    """

    def __init__(self, sym_p, vec_q, mat_g=None, vec_h=None,
                 mat_a=None, vec_b=None, eps_zero: float = 1e-12, *,
                 device=None):
        del eps_zero  # retained for API parity; eigh needs no tolerance here
        self._prob = qp(
            _from_matbuild(sym_p), _from_matbuild(vec_q),
            _from_matbuild(mat_g), _from_matbuild(vec_h),
            _from_matbuild(mat_a), _from_matbuild(vec_b), device=device,
        )
        self.n = self._prob.shape[1] - 1  # the epigraph t is the last

    def problem(self) -> ConicProblem:
        return self._prob

    def solve(self, param=None, **kw):
        from totsu_tpu_torch.solver.params import SolverParam
        return self._prob.solve(param or SolverParam(), **kw)
