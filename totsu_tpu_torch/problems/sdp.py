"""Semidefinite program -> conic form.

    minimize    c^T x
    subject to  sum_i x_i F_i + F_n <= 0   (PSD order)
                A x = b

Reduction (ref: totsu/src/problem/sdp.rs:224-259 doc; 262-365): vec()
every F_j with the scaled-vec convention (off-diagonals * sqrt2), stack
vec(F_0)..vec(F_{n-1}) as columns:

    A' = [vec(F_0) ... vec(F_{n-1}); A],  b' = [-vec(F_n); b]
    K  = vec(S+^k) x {0}^p
"""

import torch

from totsu_tpu_torch.ops import sympack
from totsu_tpu_torch.problems.base import (
    ConicProblem, _as_tensor, _asvec, _asmat, _common, _device_of,
    _from_matbuild,
)
from totsu_tpu_torch.solver import cone as cones
from totsu_tpu_torch.solver.operator import DenseOp


def sdp(c, f_mats, a=None, b=None, psd_method: str = "auto", *,
        device=None) -> ConicProblem:
    """SDP reduction. ``c`` (n,) objective, ``f_mats`` (n+1, k, k)
    stacked dense symmetric F_0..F_n; ``psd_method`` as in
    :func:`cones.psd` ('auto' resolves per solve). Tensors keep their
    device; other inputs go to ``device``, else to the device of the
    tensors given, else to the CUDA card. Missing blocks take the dtype
    and device of ``c``."""
    dev = _device_of(device, c, f_mats, a, b)
    c = _asvec(c, dev)
    n = c.shape[0]
    f_mats = _as_tensor(f_mats, dev)
    k = f_mats.shape[-1]
    a = _asmat(a, dev, 0, n, c)
    b = _asvec(b, dev, a.shape[0], c)
    p = a.shape[0]

    c, f_mats, a, b = _common(c, f_mats, a, b)
    f_vecs = sympack.pack(f_mats, scaled=True)  # (n+1, k(k+1)/2)
    conic_a = torch.cat([f_vecs[:n].T, a], dim=0).contiguous()
    conic_b = torch.cat([-f_vecs[n], b])
    layout = cones.ConeLayout(
        [cones.psd(k, method=psd_method), cones.zero(p)])
    return ConicProblem(c=c, a=DenseOp(conic_a), b=conic_b, cone=layout)


class ProbSDP:
    """Reference-style SDP wrapper (ref ProbSDP, sdp.rs:262-365).

    ``syms_f`` is a list of n+1 SymPack MatBuilds (or dense symmetric
    arrays) holding the literal matrix entries; the scaled-vec conversion
    happens in :func:`sdp`. ``device`` as there.
    """

    def __init__(self, vec_c, syms_f, mat_a=None, vec_b=None,
                 eps_zero: float = 1e-12, *, device=None):
        del eps_zero  # retained for API parity
        dev = _device_of(device, vec_c, *syms_f, mat_a, vec_b)
        f_mats = torch.stack([_as_tensor(_from_matbuild(f), dev)
                              for f in syms_f])
        self._prob = sdp(
            _from_matbuild(vec_c), f_mats,
            _from_matbuild(mat_a), _from_matbuild(vec_b), device=dev,
        )

    def problem(self) -> ConicProblem:
        return self._prob

    def solve(self, param=None, **kw):
        from totsu_tpu_torch.solver.params import SolverParam
        return self._prob.solve(param or SolverParam(), **kw)
