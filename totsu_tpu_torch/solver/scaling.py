"""Ruiz equilibration of conic problem data and the column-spread probe
(port of ``totsu_tpu.solver.scaling``).

The problem  min c^T x  s.t.  A x + s = b, s in K  is replaced by

    min (E c)^T x'  s.t.  (D A E) x' + s' = D b,  s' in K

with positive diagonal D (rows) and E (cols) built by iterated inf-norm
balancing; D is block-uniform over non-separable cone factors so that
s' = D s stays in K. The solution maps back as x = E x', y = D y'.
"""

import torch

from totsu_tpu_torch.solver.cone import ConeLayout
from totsu_tpu_torch.solver.operator import LinOp


def _group_max(cone: ConeLayout, r: torch.Tensor) -> torch.Tensor:
    """Uniform block scaling keeps the cone invariant."""
    return cone.group_reduce(r, torch.amax)


def ruiz_equilibrate_op(a_op: LinOp, b: torch.Tensor, c: torch.Tensor,
                        cone: ConeLayout, iters: int = 10):
    """Return (a_op_s, b_s, c_s, d, e) with a_op_s = diag(d) A diag(e);
    both absmaxes of a sweep are measured on the same operator before
    either scaling is applied. A :class:`BatchedDenseOp` with (B, m) b and
    (B, n) c scales each lane on its own."""
    dtype = torch.promote_types(b.dtype, c.dtype)
    # (m,) and (n,), or (B, m) and (B, n) for a batch of lanes
    d = torch.ones(b.shape, dtype=dtype, device=b.device)
    e = torch.ones(c.shape, dtype=dtype, device=b.device)
    for _ in range(iters):
        row = _group_max(cone, a_op.row_absmax())
        dr = 1.0 / torch.sqrt(torch.clamp(row, min=1e-8))
        de = 1.0 / torch.sqrt(torch.clamp(a_op.col_absmax(), min=1e-8))
        a_op = a_op.diag_scale(dr.to(dtype), de.to(dtype))
        d = d * dr
        e = e * de
    return a_op, b * d, c * e, d, e


def _spread_probe(a_op: LinOp) -> torch.Tensor:
    """The column 2-norm spread (max over nonzero columns / min over
    nonzero columns) as one scalar tensor on the operator's device:
    solve()'s auto-equilibration probe reads exactly one number per
    operator."""
    v = torch.sqrt(a_op.col_sqsum())
    pos = v > 0
    vmax = torch.where(pos, v, 0.0).amax()
    vmin = torch.where(pos, v, float("inf")).amin()
    ok = torch.isfinite(vmin) & (vmax > 0)
    return torch.where(ok, vmax / torch.clamp(vmin, min=1e-300), 1.0)


def scaling_spread(a_op: LinOp) -> float:
    """Dimensionless badness-of-scaling of the problem data: the spread
    max/min of the nonzero column 2-norms (sqrt of ``col_sqsum``, the
    diagonal that drives the indirect engine's Jacobi preconditioner).
    One device reduction and one host read. The JAX package calibrated it
    on a TPU (well-scaled instances 1.1-2.9, the ill-scaled family
    24-172); solve()'s auto policy fires past 10
    (``conic._AUTO_EQUIL_SPREAD``). It reads columns only: a row-scaled
    instance with balanced columns reads as well scaled (a known defect of
    the JAX package, mirrored)."""
    return float(_spread_probe(a_op))
