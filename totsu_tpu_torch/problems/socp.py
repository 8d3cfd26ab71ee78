"""Second-order cone program -> conic form.

    minimize    f^T x
    subject to  || Gi x + hi ||_2 <= ci^T x + di   (i = 0..m-1)
                A x = b

Reduction (ref: totsu/src/problem/socp.rs:336-377 doc; operators 49-332):

    A' = [-c0^T; -G0; ...; -c_{m-1}^T; -G_{m-1}; A]
    b' = [d0; h0; ...; d_{m-1}; h_{m-1}; b]
    K  = Q^(1+n0) x ... x Q^(1+n_{m-1}) x {0}^p

Blocks may be ragged, and degenerate (ni = 0: a 1-element SOC, which
reduces to R+; ref test_socp2, socp.rs:50-94). Runs of equal-size blocks
merge into one factor, projected batched.
"""

import torch

from totsu_tpu_torch.problems.base import (
    ConicProblem, _as_tensor, _asvec, _asmat, _common, _device_of,
    _from_matbuild,
)
from totsu_tpu_torch.solver import cone as cones
from totsu_tpu_torch.solver.operator import DenseOp


def socp(f, g_list, h_list, c_list, d_list, a=None, b=None, *,
         device=None) -> ConicProblem:
    """SOCP reduction. ``f`` (n,) objective; per cone i: ``g_list[i]``
    (ni, n) (ni may be 0 and may differ between cones), ``h_list[i]``
    (ni,), ``c_list[i]`` (n,), ``d_list[i]`` a scalar. Tensors keep their
    device; other inputs go to ``device``, else to the device of the
    tensors given, else to the CUDA card. Missing blocks take the dtype
    and device of ``f``."""
    dev = _device_of(device, f, *g_list, *h_list, *c_list, a, b)
    f = _asvec(f, dev)
    n = f.shape[0]
    a = _asmat(a, dev, 0, n, f)
    b = _asvec(b, dev, a.shape[0], f)
    p = a.shape[0]

    rows = []
    rhs = []
    factors = []
    for gi, hi, ci, di in zip(g_list, h_list, c_list, d_list):
        gi = _asmat(gi, dev, 0, n, f)
        hi = _asvec(hi, dev, gi.shape[0], f)
        ci = _asvec(ci, dev)[:n]
        ni = gi.shape[0]
        rows.append(-ci[None, :])
        rows.append(-gi)
        rhs.append(_as_tensor(di, dev).to(f.dtype).reshape(1))
        rhs.append(hi)
        # merge runs of equal-size blocks for batched projection
        if factors and factors[-1].kind == cones.SOC \
                and factors[-1].dim == 1 + ni:
            factors[-1] = cones.Factor(cones.SOC, 1 + ni,
                                       factors[-1].count + 1)
        else:
            factors.append(cones.soc(1 + ni))
    rows.append(a)
    rhs.append(b)
    factors.append(cones.zero(p))

    f, *parts = _common(f, *rows, *rhs)
    conic_a = torch.cat(parts[:len(rows)], dim=0).contiguous()
    conic_b = torch.cat(parts[len(rows):])
    return ConicProblem(c=f, a=DenseOp(conic_a), b=conic_b,
                        cone=cones.ConeLayout(factors))


class ProbSOCP:
    """Reference-style SOCP wrapper (ref ProbSOCP, socp.rs:378-472).
    ``device`` as in :func:`socp`."""

    def __init__(self, vec_f, mats_g, vecs_h, vecs_c, scls_d,
                 mat_a=None, vec_b=None, *, device=None):
        self._prob = socp(
            _from_matbuild(vec_f),
            [_from_matbuild(g) for g in mats_g],
            [_from_matbuild(h) for h in vecs_h],
            [_from_matbuild(ci) for ci in vecs_c],
            list(scls_d),
            _from_matbuild(mat_a), _from_matbuild(vec_b), device=device,
        )

    def problem(self) -> ConicProblem:
        return self._prob

    def solve(self, param=None, **kw):
        from totsu_tpu_torch.solver.params import SolverParam
        return self._prob.solve(param or SolverParam(), **kw)
