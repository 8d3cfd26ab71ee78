"""Quadratically constrained QP -> conic form: stacked rotated-SOC blocks.

    minimize    (1/2) x^T P0 x + q0^T x + r0
    subject to  (1/2) x^T Pi x + qi^T x + ri <= 0   (i = 1..m)
                A x = b

Reduction (ref: totsu/src/problem/qcqp.rs:353-400 doc; operators 9-349):
one rotated-SOC block of height 2+n per quadratic (the objective through
the epigraph variable t, which only the i = 0 block touches):

    block 0:  [[0, 0], [q0^T, -1], [-P0^1/2, 0]] [x; t] + s0 = [1, -r0, 0]
    block i:  [[0], [qi^T], [-Pi^1/2]] x        + si = [1, -ri, 0]
    A x + sz = b
    s in Qr^(2+n) x ... x Qr^(2+n) x {0}^p

Every Pi is square-rooted at build time by one batched eigh over
P0..Pm (the reference makes m+1 LAPACK calls, qcqp.rs:443-448).
"""

import torch

from totsu_tpu_torch.ops import sympack
from totsu_tpu_torch.problems.base import (
    ConicProblem, _as_tensor, _asvec, _asmat, _common, _device_of,
    _from_matbuild,
)
from totsu_tpu_torch.solver import cone as cones
from totsu_tpu_torch.solver.operator import DenseOp


def qcqp(p_mats, q_vecs, r_scls, a=None, b=None, *,
         device=None) -> ConicProblem:
    """QCQP reduction. ``p_mats`` (m+1, n, n) stacked dense symmetric PSD
    P0..Pm, ``q_vecs`` (m+1, n), ``r_scls`` (m+1,). Tensors keep their
    device; other inputs go to ``device``, else to the device of the
    tensors given, else to the CUDA card. Missing blocks take the dtype
    and device of ``q_vecs``."""
    dev = _device_of(device, p_mats, q_vecs, r_scls, a, b)
    p_mats = _as_tensor(p_mats, dev)
    q_vecs = _as_tensor(q_vecs, dev)
    r_scls = _asvec(r_scls, dev)
    m1, n = q_vecs.shape
    a = _asmat(a, dev, 0, n, q_vecs)
    b = _asvec(b, dev, a.shape[0], q_vecs)
    p = a.shape[0]

    p_mats, q_vecs, r_scls, a, b = _common(p_mats, q_vecs, r_scls, a, b)
    dtype = q_vecs.dtype
    p_sqrts = sympack.psd_sqrt(p_mats)  # one batched eigh

    def zeros(*shape):
        return torch.zeros(*shape, dtype=dtype, device=q_vecs.device)

    # per-quadratic block rows over [x; t]: a zero row, [qi^T, -delta_i0],
    # [-Pi^1/2, 0]; all m+1 blocks at once, then stacked
    t_col = zeros(m1, 1)
    t_col[0, 0] = -1.0
    row1 = torch.cat([q_vecs[:, None, :], t_col[:, None, :]], dim=2)
    rows2 = torch.cat([-p_sqrts, zeros(m1, n, 1)], dim=2)
    blocks = torch.cat([zeros(m1, 1, n + 1), row1, rows2], dim=1)
    conic_a = torch.cat([
        blocks.reshape(m1 * (2 + n), n + 1),
        torch.cat([a, zeros(p, 1)], dim=1),
    ], dim=0).contiguous()
    b_blocks = torch.cat([torch.ones_like(t_col), -r_scls[:, None],
                          zeros(m1, n)], dim=1)  # (m+1, 2+n)
    conic_b = torch.cat([b_blocks.reshape(m1 * (2 + n)), b])
    conic_c = zeros(n + 1)
    conic_c[n] = 1.0
    layout = cones.ConeLayout(
        [cones.rsoc(2 + n, count=m1), cones.zero(p)])
    return ConicProblem(c=conic_c, a=DenseOp(conic_a), b=conic_b,
                        cone=layout)


class ProbQCQP:
    """Reference-style QCQP wrapper (ref ProbQCQP, qcqp.rs:401-498).
    ``syms_p``: SymPack MatBuilds or dense symmetric arrays. The
    solution's first n entries are x (the last is the epigraph t).
    ``device`` as in :func:`qcqp`."""

    def __init__(self, syms_p, vecs_q, scls_r, mat_a=None, vec_b=None,
                 eps_zero: float = 1e-12, *, device=None):
        del eps_zero  # retained for API parity; eigh needs no tolerance
        dev = _device_of(device, *syms_p, *vecs_q, mat_a, vec_b)
        p_mats = torch.stack([_as_tensor(_from_matbuild(p), dev)
                              for p in syms_p])
        q_vecs = torch.stack([_asvec(_from_matbuild(q), dev)
                              for q in vecs_q])
        self._prob = qcqp(
            p_mats, q_vecs, _as_tensor(scls_r, dev),
            _from_matbuild(mat_a), _from_matbuild(vec_b), device=dev,
        )
        self.n = q_vecs.shape[1]

    def problem(self) -> ConicProblem:
        return self._prob

    def solve(self, param=None, **kw):
        from totsu_tpu_torch.solver.params import SolverParam
        return self._prob.solve(param or SolverParam(), **kw)
