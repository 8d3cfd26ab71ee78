"""Cones as projection functions over a static product layout.

Port of ``totsu_tpu.solver.cone``: a cone is static metadata (a
:class:`ConeLayout` of :class:`Factor` s, plain Python) plus projection
functions over the concatenated slack vector. Runs of equal-size blocks
are projected batched (reshape + row-wise math).

========  =====================================================================
zero      {0}^n; primal -> 0, dual -> identity
rpos      R+^n; elementwise max(x, 0); self-dual
soc       {(s, v) : ||v|| <= s}; 3-case projection; self-dual
rsoc      {x3^2+... <= 2 x1 x2, x1,x2 >= 0}; Givens-rotate into soc
exp       {(r, s, t) : s e^{r/s} <= t, s > 0} closure; Newton-bisection root
pow       {(x, y, z) : x^a y^(1-a) >= |z|, x, y >= 0}; Newton-bisection root
psd       vec(S+^k) in the scaled-vec convention; eigh, Newton-Schulz or
          Jacobi, then clip (``ops/sympack.py`` ``proj_psd_packed``)
custom    the user's projection of (count, dim) blocks; dual by Moreau
========  =====================================================================

The exp and pow cones are not self-dual: their dual projections use the
Moreau identity proj_{K*}(x) = x + proj_K(-x). For CPU tensors their
blocks go through the plain PyTorch cores below; for CUDA tensors through
the blocked projection kernel (``ops/kernels/cone_proj.py``), which runs
the same cases and Newton step with L lanes of a warp per block.

The PSD cone is self-dual. Its ``'jacobi'`` method projects all blocks
of a factor in one launch of kernel J on a CUDA tensor
(``ops/kernels/psd_jacobi.py``); ``'auto'`` factors are resolved per
solve by :func:`resolve_auto_methods`.
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
    """PSD cone blocks vec(S+^k), each of packed length k(k+1)/2.

    ``method``: 'eigh' (exact; on the card ``torch.linalg.eigh``
    synchronizes the host at every projection), 'ns' (Newton-Schulz
    matrix sign, batched matmuls, about 5e-6 error floor), 'jacobi'
    (parallel-order Jacobi, exact; one launch of kernel J per factor on
    the card) or 'auto' (picked per solve by
    :func:`resolve_auto_methods`)."""
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
    """User-defined cone factor (the reference's public ``Cone`` trait).

    ``proj(blocks)`` is the Euclidean projection onto the primal cone K:
    it receives a ``(count, dim)`` tensor on the solve's device, in its
    dtype, and returns one of the same shape, device and dtype. The dual
    projection is the Moreau form ``x + proj(-x)`` unless ``dual_proj``
    gives one (for a self-dual cone, pass the same function).
    ``grouped=False`` marks the cone separable per element, so the
    diagonal preconditioner keeps per-element scales; the default groups
    each block to one scale (:attr:`Factor.needs_group`)."""
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


#: Trip counts of the fixed-trip root finders, as in the JAX package: the
#: exp bracket expansion, the exp Newton-bisection hybrid and the pow
#: hybrid (by dtype: f32, f64). The pow counts keep the full bisection
#: guarantee (at the |z0| endpoint an r-error of eps becomes a y-error of
#: about sqrt(eps)).
EXP_EXPAND_TRIPS = 40
EXP_TRIPS = {torch.float32: 26, torch.float64: 38}
POW_TRIPS = {torch.float32: 28, torch.float64: 54}


def _fixed_trips(step, state, trips: int):
    """``trips`` applications of ``step`` to the tuple ``state``, stopping
    as soon as a trip leaves every tensor of the state unchanged: the trip
    is a function of the state alone, so the result is that of all
    ``trips`` trips, bit for bit, with fewer eager launches."""
    for _ in range(trips):
        nxt = step(state)
        if all(torch.equal(a, b) for a, b in zip(nxt, state)):
            break
        state = nxt
    return state


def _on_roots(root, outs, solve, *args):
    """Write ``solve(*args[root])`` into the tensors ``outs`` at the
    elements where ``root`` holds: the root finders run only on the
    blocks that need them (each of the CUDA kernels' blocks does the
    same), so the other blocks' discarded arithmetic neither costs eager
    launches nor keeps the fixed-trip loops from their fixed point."""
    idx = root.nonzero()[:, 0]
    if idx.numel():
        sub = [x[idx] if isinstance(x, torch.Tensor) and x.dim() else x
               for x in args]
        for out, val in zip(outs, solve(*sub)):
            out[idx] = val
    return outs


def _exp_h(rho, r0, s0, t0, grad: bool):
    """h(rho) of the exp root problem rescaled by e^{-|rho|} (rho^2 - rho
    + 1) > 0, from e^{-|rho|} and e^{-2|rho|} only (every term bounded);
    with ``grad`` also its derivative."""
    num1 = (rho - 1.0) * r0 + s0          # coefficient of e^{rho}
    num2 = r0 - rho * s0                  # coefficient of e^{-rho}
    den = rho * (rho - 1.0) + 1.0         # > 0 for all rho
    e1 = torch.exp(-rho.abs())
    e2 = torch.exp(-2.0 * rho.abs())
    take_pos = rho >= 0
    v = torch.where(take_pos, num1 - num2 * e2, num1 * e2 - num2) \
        - t0 * den * e1
    if not grad:
        return v
    denp = 2.0 * rho - 1.0
    g = torch.where(take_pos, r0 + (s0 + 2.0 * num2) * e2,
                    (r0 + 2.0 * num1) * e2 + s0) \
        - t0 * torch.where(take_pos, denp - den, denp + den) * e1
    return v, g


def _exp_bracket(r0, s0):
    """The root's bracket (lo, hi) from the validity constraints s(rho) >
    0, lambda(rho) > 0; at most one end is infinite for blocks outside K,
    its polar and the negative quadrant:
      r0 > 0 -> rho > 1 - s0/r0        r0 < 0 -> rho < 1 - s0/r0
      s0 < 0 -> rho > r0/s0            s0 > 0 -> rho < r0/s0"""
    safe_s = torch.where(s0 != 0, s0, 1.0)
    safe_r = torch.where(r0 != 0, r0, 1.0)
    inf = float("inf")
    lo = torch.maximum(torch.where(r0 > 0, 1.0 - s0 / safe_r, -inf),
                       torch.where(s0 < 0, r0 / safe_s, -inf))
    hi = torch.minimum(torch.where(r0 < 0, 1.0 - s0 / safe_r, inf),
                       torch.where(s0 > 0, r0 / safe_s, inf))
    return lo, hi


def _exp_hybrid(state, r0, s0, t0):
    """One trip of the safeguarded Newton-bisection on h, rtsafe-style:
    the sign at r shrinks the bracket like bisection; the next point is
    the Newton step when it lands strictly inside the bracket, or rounds
    to r itself (converged to the last ULP: without this the iterate would
    be thrown back to the midpoint of a stale one-sided bracket), else the
    midpoint."""
    lo_f, hi_f, r = state
    v, g = _exp_h(r, r0, s0, t0, True)
    neg = v < 0                           # h increasing: root above r
    lo_f = torch.where(neg, r, lo_f)
    hi_f = torch.where(neg, hi_f, r)
    nxt = r - v / torch.where(g != 0, g, 1.0)
    ok = torch.isfinite(nxt) & (g != 0) & \
        (((nxt > lo_f) & (nxt < hi_f)) | (nxt == r))
    return lo_f, hi_f, torch.where(ok, nxt, 0.5 * (lo_f + hi_f))


def _exp_from_root(rho, r0, s0, t0):
    """The projection (r, s, t) at the root rho."""
    den = rho * (rho - 1.0) + 1.0
    s = torch.clamp(((rho - 1.0) * r0 + s0) / den, min=0.0)
    # t: the boundary form s e^rho is ill-conditioned for rho >> 0, the
    # KKT form t0 + lambda(rho) for rho << 0; take the damped one
    t_kkt = t0 + (r0 - rho * s0) * torch.exp(-torch.clamp(rho, min=0.0)) \
        / den
    t = torch.clamp(torch.where(rho >= 0, t_kkt, s * torch.exp(rho)),
                    min=0.0)
    return rho * s, s, t


def _exp_root(r0, s0, t0):
    """The exp projection of blocks outside K, its polar and the negative
    quadrant (see :func:`_proj_exp_rst`): bracket expansion, then the
    Newton-bisection hybrid."""
    lo, hi = _exp_bracket(r0, s0)
    lo_inf, hi_inf = torch.isinf(lo), torch.isinf(hi)

    def expand(state):
        # double the (at most one) infinite end until h changes sign
        lo_f, hi_f = state
        hi_f = torch.where(hi_inf & (_exp_h(hi_f, r0, s0, t0, False) < 0),
                           lo_f + 2.0 * (hi_f - lo_f), hi_f)
        lo_f = torch.where(lo_inf & (_exp_h(lo_f, r0, s0, t0, False) > 0),
                           hi_f + 2.0 * (lo_f - hi_f), lo_f)
        return lo_f, hi_f

    lo_f, hi_f = _fixed_trips(
        expand, (torch.where(torch.isfinite(lo), lo, hi - 1.0),
                 torch.where(torch.isfinite(hi), hi, lo + 1.0)),
        EXP_EXPAND_TRIPS)
    _, _, rho = _fixed_trips(lambda st: _exp_hybrid(st, r0, s0, t0),
                             (lo_f, hi_f, 0.5 * (lo_f + hi_f)),
                             EXP_TRIPS[r0.dtype])
    return _exp_from_root(rho, r0, s0, t0)


def _proj_exp_rst(r0, s0, t0, root=_exp_root):
    """Elementwise exponential-cone projection: same-shaped 1-D tensors
    (r0, s0, t0), each element an independent block, to the projected
    (r, s, t). Port of ``totsu_tpu.solver.cone._proj_exp_rst`` (Friberg,
    Optim. Letters 2023): the non-trivial case is the root of the
    increasing scalar function

        h(rho) = [((rho-1) r0 + s0) e^rho - (r0 - rho s0) e^{-rho}]
                 / (rho^2 - rho + 1)  -  t0,

    found by bracket expansion and a safeguarded Newton-bisection hybrid
    on h rescaled by e^{-|rho|}(rho^2 - rho + 1) > 0, so that every term
    stays bounded while the expansion pushes rho to +-2^40.

    Trivial cases, in order of precedence: v0 in K -> v0; v0 in the polar
    -> 0; r0 <= 0 and s0 <= 0 -> (r0, 0, max(t0, 0)). ``root`` projects
    the other blocks (:func:`_exp_root`; the CUDA kernel's lane-parallel
    root finder has a torch model that passes its own).
    """
    e = torch.tensor(torch.e, dtype=r0.dtype, device=r0.device)
    safe_s = torch.where(s0 != 0, s0, 1.0)
    safe_r = torch.where(r0 != 0, r0, 1.0)
    in_cone = ((s0 > 0) & (s0 * torch.exp(r0 / safe_s) <= t0)) | \
        ((s0 == 0) & (r0 <= 0) & (t0 >= 0))
    in_polar = ((r0 > 0) & (r0 * torch.exp(s0 / safe_r) <= -e * t0)) | \
        ((r0 == 0) & (s0 <= 0) & (t0 <= 0))
    neg_quad = (r0 <= 0) & (s0 <= 0)
    zero = torch.zeros_like(r0)
    out_r = torch.where(in_cone | (neg_quad & ~in_polar), r0, zero)
    out_s = torch.where(in_cone, s0, zero)
    out_t = torch.where(in_cone, t0, torch.where(
        in_polar, zero, torch.clamp(t0, min=0.0)))
    return _on_roots(~(in_cone | in_polar | neg_quad), (out_r, out_s, out_t),
                     root, r0, s0, t0)


def _proj_exp_blocks(xb: torch.Tensor) -> torch.Tensor:
    """Batched exp-cone projection over (count, 3) blocks."""
    return torch.stack(_proj_exp_rst(xb[:, 0], xb[:, 1], xb[:, 2]), dim=1)


def _pow_half_quad(w0, coef, q):
    """(w0 + sqrt(w0^2 + 4 c q)) / 2 and the square root; for w0 < 0 the
    conjugate 2cq / (sqrt - w0), which does not cancel."""
    s = torch.sqrt(w0 * w0 + 4.0 * coef * q)
    return torch.where(w0 >= 0, 0.5 * (w0 + s),
                       2.0 * coef * q / torch.clamp(s - w0,
                                                    min=_TINY[w0.dtype])), s


def _pow_phi(r, x0, y0, az, a, grad: bool):
    """phi(r) = a log x(r) + (1-a) log y(r) - log r, decreasing in r; with
    ``grad`` also its derivative a^2 q'/(x sx) + (1-a)^2 q'/(y sy) - 1/r."""
    b = 1.0 - a
    tiny = _TINY[x0.dtype]
    q = r * (az - r)
    xr, sx = _pow_half_quad(x0, a, q)
    yr, sy = _pow_half_quad(y0, b, q)
    v = (a * torch.log(torch.clamp(xr, min=tiny))
         + b * torch.log(torch.clamp(yr, min=tiny))
         - torch.log(torch.clamp(r, min=tiny)))
    if not grad:
        return v
    qp = az - 2.0 * r
    g = (a * a * qp / torch.clamp(xr * sx, min=tiny)
         + b * b * qp / torch.clamp(yr * sy, min=tiny)
         - 1.0 / torch.clamp(r, min=tiny))
    return v, g


def _pow_hybrid(state, x0, y0, az, a):
    """One trip of the safeguarded Newton-bisection on phi (see
    :func:`_exp_hybrid`)."""
    lo, hi, r = state
    v, g = _pow_phi(r, x0, y0, az, a, True)
    pos = v > 0                           # phi decreasing: root above
    lo = torch.where(pos, r, lo)
    hi = torch.where(pos, hi, r)
    nxt = r - v / torch.where(g != 0, g, 1.0)
    ok = torch.isfinite(nxt) & (g != 0) & \
        (((nxt > lo) & (nxt < hi)) | (nxt == r))
    return lo, hi, torch.where(ok, nxt, 0.5 * (lo + hi))


def _pow_from_root(r, x0, y0, az, a):
    """The projected (x(r), y(r), r) at the root r."""
    q = r * (az - r)
    return _pow_half_quad(x0, a, q)[0], _pow_half_quad(y0, 1.0 - a, q)[0], r


def _pow_root(x0, y0, az, a):
    """r = |z| of the pow projection of pre-scaled blocks outside K, its
    polar and z = 0, and the projected (x(r), y(r)) (see
    :func:`_proj_pow_rst`): the Newton-bisection hybrid on (0, |z0|)."""
    _, _, r = _fixed_trips(lambda st: _pow_hybrid(st, x0, y0, az, a),
                           (torch.zeros_like(az), az, 0.5 * az),
                           POW_TRIPS[x0.dtype])
    return _pow_from_root(r, x0, y0, az, a)


_TINY = {torch.float32: 1e-38, torch.float64: 1e-300}


def _proj_pow_rst(x0, y0, z0, alpha, root=_pow_root):
    """Elementwise power-cone projection: same-shaped 1-D tensors (x0,
    y0, z0), each element an independent block; ``alpha`` is a float or a
    tensor of the same shape (per-block exponents). Port of
    ``totsu_tpu.solver.cone._proj_pow_rst`` (Hien 2015, prop. 2.2): the
    non-trivial case projects onto the boundary x^a y^(1-a) = |z|, a
    scalar root problem on r = |z_proj| in (0, |z0|):

        x(r) = (x0 + sqrt(x0^2 + 4 a r (|z0| - r))) / 2
        y(r) = (y0 + sqrt(y0^2 + 4 (1-a) r (|z0| - r))) / 2
        Phi(r) = x(r)^a y(r)^(1-a) - r = 0,

    solved by a safeguarded Newton-bisection hybrid with the sign test in
    the log domain. Blocks are pre-scaled by their max-abs (projections
    onto cones are positively homogeneous), so no input overflows.

    Trivial cases, in order of precedence: v0 in K -> v0; v0 in the polar
    -K* -> 0; z0 = 0 -> (max(x0, 0), max(y0, 0), 0). ``root`` solves
    the other blocks (:func:`_pow_root`; see :func:`_proj_exp_rst`).
    """
    a = alpha
    tiny = _TINY[x0.dtype]
    scl = torch.maximum(torch.maximum(x0.abs(), y0.abs()),
                        torch.clamp(z0.abs(), min=1e-30))
    x0, y0, z0 = x0 / scl, y0 / scl, z0 / scl
    az = z0.abs()

    def pow_val(x, y):
        """x^a y^(1-a) for x, y >= 0 (0 when either is 0)."""
        v = torch.exp(a * torch.log(torch.clamp(x, min=tiny))
                      + (1.0 - a) * torch.log(torch.clamp(y, min=tiny)))
        return torch.where((x > 0) & (y > 0), v, 0.0)

    in_cone = (x0 >= 0) & (y0 >= 0) & (pow_val(x0, y0) >= az)
    in_polar = (x0 <= 0) & (y0 <= 0) & \
        (pow_val(-x0 / a, -y0 / (1.0 - a)) >= az)
    z_zero = az == 0
    zero = torch.zeros_like(x0)
    out_x = torch.where(in_cone, x0, torch.where(
        in_polar, zero, torch.clamp(x0, min=0.0)))
    out_y = torch.where(in_cone, y0, torch.where(
        in_polar, zero, torch.clamp(y0, min=0.0)))
    out_r = torch.where(in_cone, az, zero)
    _on_roots(~(in_cone | in_polar | z_zero), (out_x, out_y, out_r),
              root, x0, y0, az, a)
    return out_x * scl, out_y * scl, torch.sign(z0) * out_r * scl


def _proj_pow_blocks(xb: torch.Tensor, alpha) -> torch.Tensor:
    """Batched power-cone projection over (count, 3) blocks."""
    return torch.stack(_proj_pow_rst(xb[:, 0], xb[:, 1], xb[:, 2], alpha),
                       dim=1)


def _project_factor(f: Factor, seg: torch.Tensor, dual: bool) -> torch.Tensor:
    """Project one factor's segment: (total,), or (B, total) with a
    leading lane dimension, whose B x count blocks go through one call of
    the block projection (one kernel launch for exp, pow and 'jacobi')."""
    if f.total == 0:
        return seg
    if f.kind == ZERO:
        return seg if dual else torch.zeros_like(seg)
    if f.kind == RPOS:
        return torch.clamp(seg, min=0.0)
    blocks = seg.reshape(-1, f.dim)
    if f.kind == SOC:
        out = _proj_soc_blocks(blocks)
    elif f.kind == RSOC:
        out = _proj_rsoc_blocks(blocks)
    elif f.kind in (EXP, POW):
        # the blocked kernel for CUDA tensors, the cores above for CPU
        # tensors; duals by the Moreau identity
        from totsu_tpu_torch.ops.kernels import cone_proj
        out = cone_proj.cone_proj(blocks, f.kind, f.alpha, dual)
    elif f.kind == PSD:
        # self-dual; an 'auto' factor projected outside a solve (nothing
        # to resolve it against) uses the exact default, as in the JAX
        # package; solve_jit resolves 'auto' at entry
        out = sympack.proj_psd_packed(
            blocks, scaled=True,
            method="eigh" if f.variant in ("", "auto") else f.variant)
    elif f.kind == CUSTOM:
        if dual:
            out = (f.dual_proj(blocks) if f.dual_proj is not None
                   else blocks + f.proj(-blocks))  # Moreau decomposition
        else:
            out = f.proj(blocks)
    else:
        raise ValueError(f"unknown cone kind {f.kind!r}")
    return out.reshape(seg.shape)


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
        """Euclidean projection of the full slack vector onto K (or K*):
        ``x`` is (dim,), or (B, dim) for B lanes of one layout."""
        segs = []
        off = 0
        for f in self.factors:
            segs.append(_project_factor(f, x[..., off:off + f.total], dual))
            off += f.total
        if not segs:
            return x
        return torch.cat(segs, dim=-1) if len(segs) > 1 else segs[0]

    def group_reduce(self, t: torch.Tensor, reduce_fn) -> torch.Tensor:
        """Replace each block of every ``needs_group`` factor of ``t`` by
        ``reduce_fn(blocks, dim=-1, keepdim=True)`` over the block — the
        grouping walk shared by the preconditioner (min) and Ruiz
        equilibration (max). ``t`` is (dim,) or (B, dim)."""
        segs = []
        off = 0
        for f in self.factors:
            seg = t[..., off:off + f.total]
            if f.needs_group and f.total > 0:
                blocks = seg.reshape(*seg.shape[:-1], f.count, f.dim)
                seg = reduce_fn(blocks, dim=-1, keepdim=True).expand(
                    blocks.shape).reshape(seg.shape)
            segs.append(seg)
            off += f.total
        if not segs:
            return t
        return torch.cat(segs, dim=-1) if len(segs) > 1 else segs[0]

    def group_min(self, t: torch.Tensor) -> torch.Tensor:
        """Preconditioner grouping (see :meth:`group_reduce`)."""
        return self.group_reduce(t, torch.amin)


def resolve_auto_methods(layout: ConeLayout, param) -> ConeLayout:
    """Resolve ``psd(..., method='auto')`` factors to a projection method
    for one solve; called at solve entry with the original param (before
    the fast profile rewrites ``profile``), as in the JAX package.

    * ``profile='fast'``, ``eps_acc >= 1e-4`` and ``k >= 16``: 'ns';
    * else 'jacobi' for many small blocks (``k <= 16`` and ``count >=
      64``);
    * else 'eigh'.

    The cuts are the JAX package's TPU measurements (its BASELINE.md SDP
    sweep), ported as structure: unmeasured on the H100 (ROADMAP item
    17)."""
    if not any(f.kind == PSD and f.variant == "auto" for f in layout.factors):
        return layout
    fast = (getattr(param, "profile", "reference") == "fast"
            and param.eps_acc >= 1e-4)
    out = []
    for f in layout.factors:
        if f.kind == PSD and f.variant == "auto":
            k = sympack.order_from_len(f.dim)
            if fast and k >= 16:
                v = "ns"
            elif k <= 16 and f.count >= 64:
                v = "jacobi"
            else:
                v = "eigh"
            f = dataclasses.replace(f, variant=v)
        out.append(f)
    return ConeLayout(out)
