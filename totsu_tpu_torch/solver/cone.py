"""Cones as projection functions over a static product layout.

Port of ``totsu_tpu.solver.cone`` for the pdhg slice: a cone is static
metadata (a :class:`ConeLayout` of :class:`Factor` s, plain Python) plus
projection functions over the concatenated slack vector. Runs of
equal-size blocks are projected batched (reshape + row-wise math).

========  =====================================================================
zero      {0}^n; primal -> 0, dual -> identity
rpos      R+^n; elementwise max(x, 0); self-dual
soc       {(s, v) : ||v|| <= s}; 3-case projection; self-dual
rsoc      {x3^2+... <= 2 x1 x2, x1,x2 >= 0}; Givens-rotate into soc
========  =====================================================================

``psd``, ``expc``, ``powc`` and ``custom`` factors can be built (so layouts
carry across from the JAX package), but projecting them raises
``NotImplementedError``: they are ROADMAP §1 item 11.
"""

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from totsu_tpu_torch.ops import sympack

ZERO = "zero"
RPOS = "rpos"
SOC = "soc"
RSOC = "rsoc"
PSD = "psd"
EXP = "exp"
POW = "pow"
CUSTOM = "custom"

# factors needing per-block preconditioner grouping
_GROUPED = (SOC, RSOC, PSD, EXP, POW)


@dataclasses.dataclass(frozen=True)
class Factor:
    """``count`` consecutive blocks of ``dim`` slack elements each."""
    kind: str
    dim: int
    count: int = 1
    variant: str = ""
    proj: Optional[Callable] = None
    dual_proj: Optional[Callable] = None
    grouped: bool = True
    alpha: float = 0.0  # power-cone exponent (POW factors only)

    @property
    def total(self) -> int:
        return self.dim * self.count

    @property
    def needs_group(self) -> bool:
        """True when diagonal scalings must be uniform within each block of
        this factor for the cone to stay invariant."""
        return self.kind in _GROUPED or (self.kind == CUSTOM and self.grouped)


def zero(n: int) -> Factor:
    return Factor(ZERO, n)


def rpos(n: int) -> Factor:
    return Factor(RPOS, n)


def soc(dim: int, count: int = 1) -> Factor:
    """``count`` second-order cone blocks, each of total length ``dim``
    (1 radius element + dim-1 vector elements)."""
    return Factor(SOC, dim, count)


def rsoc(dim: int, count: int = 1) -> Factor:
    """Rotated second-order cone blocks of total length ``dim``."""
    return Factor(RSOC, dim, count)


def psd(k: int, count: int = 1, method: str = "auto") -> Factor:
    """PSD cone blocks vec(S+^k), each of packed length k(k+1)/2."""
    if method not in ("auto", "eigh", "ns", "jacobi"):
        raise ValueError(f"unknown PSD projection method {method!r}; "
                         "expected 'auto', 'eigh', 'ns' or 'jacobi'")
    return Factor(PSD, sympack.tri_len(k), count, variant=method)


def expc(count: int = 1) -> Factor:
    """``count`` exponential-cone blocks (x, y, z) of length 3 each."""
    return Factor(EXP, 3, count)


def powc(alpha: float, count: int = 1) -> Factor:
    """``count`` three-dimensional power-cone blocks with exponent alpha."""
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"power cone exponent must be in (0, 1), "
                         f"got {alpha}")
    return Factor(POW, 3, count, alpha=float(alpha))


def custom(dim: int, proj: Callable, count: int = 1, *,
           dual_proj: Optional[Callable] = None, grouped: bool = True,
           name: str = "custom") -> Factor:
    """User-defined cone factor (projection not yet ported)."""
    return Factor(CUSTOM, dim, count, variant=name, proj=proj,
                  dual_proj=dual_proj, grouped=grouped)


def _proj_soc_blocks(xb: torch.Tensor) -> torch.Tensor:
    """Batched SOC projection. xb: (count, d) with xb[:, 0] the radius.

      ||v|| <= -s  ->  0
      ||v|| <=  s  ->  unchanged
      otherwise    ->  ((||v||+s)/2, alpha*v),  alpha = (1 + s/||v||)/2
    Works for d == 1 (empty v, reduces to max(s, 0)).
    """
    s = xb[:, :1]
    v = xb[:, 1:]
    nv = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    safe_nv = torch.where(nv > 0, nv, 1.0)
    alpha = (1.0 + s / safe_nv) * 0.5
    out_v = torch.where(nv <= -s, 0.0, torch.where(nv <= s, v, alpha * v))
    out_s = torch.where(nv <= -s, 0.0,
                        torch.where(nv <= s, s, (nv + s) * 0.5))
    return torch.cat([out_s, out_v], dim=1)


_INV_SQRT2 = 1.0 / sympack.SQRT2


def _proj_rsoc_blocks(xb: torch.Tensor) -> torch.Tensor:
    """Batched rotated-SOC projection: rotate the first two coords by the
    involutive Givens map (r, s) -> ((r+s)/sqrt2, (r-s)/sqrt2), project
    onto SOC, rotate back. d == 1 -> max(x, 0)."""
    if xb.shape[1] == 1:
        return torch.clamp(xb, min=0.0)

    def rot(z):
        r = (z[:, :1] + z[:, 1:2]) * _INV_SQRT2
        s = (z[:, :1] - z[:, 1:2]) * _INV_SQRT2
        return torch.cat([r, s, z[:, 2:]], dim=1)

    return rot(_proj_soc_blocks(rot(xb)))


def _project_factor(f: Factor, seg: torch.Tensor, dual: bool) -> torch.Tensor:
    if f.total == 0:
        return seg
    if f.kind == ZERO:
        return seg if dual else torch.zeros_like(seg)
    if f.kind == RPOS:
        return torch.clamp(seg, min=0.0)
    blocks = seg.reshape(f.count, f.dim)
    if f.kind == SOC:
        out = _proj_soc_blocks(blocks)
    elif f.kind == RSOC:
        out = _proj_rsoc_blocks(blocks)
    elif f.kind in (PSD, EXP, POW, CUSTOM):
        raise NotImplementedError(
            f"projection onto the {f.kind!r} cone is not ported yet "
            "(ROADMAP §1 item 11: remaining cones)")
    else:
        raise ValueError(f"unknown cone kind {f.kind!r}")
    return out.reshape(f.total)


@dataclasses.dataclass(frozen=True)
class ConeLayout:
    """A product cone: ordered factors over a concatenated slack vector."""
    factors: Tuple[Factor, ...]

    def __init__(self, factors):
        object.__setattr__(self, "factors", tuple(factors))

    @property
    def dim(self) -> int:
        return sum(f.total for f in self.factors)

    def project(self, x: torch.Tensor, dual: bool) -> torch.Tensor:
        """Euclidean projection of the full slack vector onto K (or K*)."""
        segs = []
        off = 0
        for f in self.factors:
            segs.append(_project_factor(f, x[off:off + f.total], dual))
            off += f.total
        if not segs:
            return x
        return torch.cat(segs) if len(segs) > 1 else segs[0]

    def group_reduce(self, t: torch.Tensor, reduce_fn) -> torch.Tensor:
        """Replace each block of every ``needs_group`` factor of ``t`` by
        ``reduce_fn(blocks, dim=1, keepdim=True)`` over the block — the
        grouping walk shared by the preconditioner (min) and Ruiz
        equilibration (max)."""
        segs = []
        off = 0
        for f in self.factors:
            seg = t[off:off + f.total]
            if f.needs_group and f.total > 0:
                blocks = seg.reshape(f.count, f.dim)
                seg = reduce_fn(blocks, dim=1, keepdim=True).expand(
                    blocks.shape).reshape(f.total)
            segs.append(seg)
            off += f.total
        if not segs:
            return t
        return torch.cat(segs) if len(segs) > 1 else segs[0]

    def group_min(self, t: torch.Tensor) -> torch.Tensor:
        """Preconditioner grouping (see :meth:`group_reduce`)."""
        return self.group_reduce(t, torch.amin)
