"""The derivative of the projection onto C = R^n x K* x R+, as linear maps.

Implicit differentiation through a solve (``totsu_tpu_torch/diff.py``)
applies DPi(z), the Jacobian of the projection onto C = R^n x K* x R+ at
the embedding point z, and its transpose at every LSQR step. The JAX
package takes both from ``jax.jvp`` / ``jax.vjp`` of its cone
projections. The port cannot: on a CUDA tensor the exp/pow projection is
kernel B (``ops/kernels/cone_proj.py``) and the 'jacobi' PSD projection
kernel J (``ops/kernels/psd_jacobi.py``), neither of which has a
derivative, and autograd of their plain versions would run a kernel's
plain version on the card. So DPi is built here in closed form, once per
backward or forward call, by :func:`dproj_at`; every LSQR step then
applies it with a few tensor operations and recomputes nothing.

The rules, per factor of K* (the y part; x is the identity and tau the
R+ rule):

* zero (its dual is the whole space): the identity;
* R+: 1 where z > 0, 0 where z < 0, 1/2 at an exact tie (what the JAX
  package's ``jnp.maximum`` gives);
* SOC: the identity inside, 0 in the polar cone, otherwise
  1/2 [[1, v^T], [v, (1 + t/||v||) I - (t/||v||) v v^T]] with
  v = v/||v||;
* RSOC: the SOC rule through the involutive rotation the projection uses;
* PSD: the eigenvector formula from one ``torch.linalg.eigh`` of z's
  blocks, whatever method projects them: DPi(Z)[dZ] = V (B o (V^T dZ V))
  V^T with B_ij = (l_i^+ - l_j^+) / (l_i - l_j), 1 where both eigenvalues
  are positive and 0 where neither is, applied in the scaled-vec packing;
* exp and pow (not self-dual: DPi_K*(z) = I - DPi_K(-z) by Moreau):
  implicit differentiation of the projection onto the smooth boundary
  g(p) = 0 that the root finder solves. The KKT system p - v + mu grad
  g(p) = 0, g(p) = 0 differentiates to [[H, grad g], [grad g^T, 0]] with
  H = I + mu hess g(p), a rank-one update of I; so DPi = P - q q^T /
  (grad g^T q), P = H^-1 and q = P grad g, a 3 x 3 matrix per block, from
  z and the projection's output with the projection's own in-cone, polar
  and zero-case masks;
* custom: ``torch.func.vjp`` of the user's projection (its linearization
  kept once) and ``torch.func.jvp`` per call, as the JAX package does
  with ``jax.jvp``.

DPi is symmetric for every convex cone but the custom one's numerics, so
the closed forms apply one map both ways; exp and pow keep their 3 x 3
matrices and apply the transpose for DPi^T.
"""

import dataclasses
import math
from typing import Callable, List, Tuple

import torch

from totsu_tpu_torch.ops import sympack
from totsu_tpu_torch.solver import cone as cones
from totsu_tpu_torch.solver.cone import ConeLayout, Factor
from totsu_tpu_torch.solver.operator import full_f32_matmul


def _step(z: torch.Tensor) -> torch.Tensor:
    """The derivative of max(z, 0): 1 above 0, 0 below, 1/2 at 0."""
    return torch.where(z > 0, 1.0, torch.where(z < 0, 0.0, 0.5)).to(z.dtype)


def _soc_map(xb: torch.Tensor) -> Callable:
    """DPi of the SOC projection at (count, d) blocks ``xb`` (radius
    first), as a map of (count, d) blocks; symmetric."""
    t = xb[:, :1]
    v = xb[:, 1:]
    nv = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    polar = nv <= -t
    inside = (nv <= t) & ~polar
    safe = torch.where(nv > 0, nv, 1.0)
    vh = v / safe
    ratio = t / safe

    def apply(db):
        dt = db[:, :1]
        dw = db[:, 1:]
        pr = (vh * dw).sum(dim=1, keepdim=True)
        out = torch.cat([0.5 * (dt + pr),
                         0.5 * (dt * vh + (1.0 + ratio) * dw
                                - ratio * vh * pr)], dim=1)
        return torch.where(polar, 0.0, torch.where(inside, db, out))

    return apply


def _rot(z: torch.Tensor) -> torch.Tensor:
    """The involutive Givens rotation of an RSOC block's first two
    coordinates (the projection's own, ``cone._proj_rsoc_blocks``)."""
    r = (z[:, :1] + z[:, 1:2]) * cones._INV_SQRT2
    s = (z[:, :1] - z[:, 1:2]) * cones._INV_SQRT2
    return torch.cat([r, s, z[:, 2:]], dim=1)


def _psd_map(blocks: torch.Tensor) -> Callable:
    """DPi of the PSD projection at packed scaled-vec blocks, from one
    eigendecomposition (on a CUDA tensor ``torch.linalg.eigh`` waits for
    the card once per backward or forward call); symmetric."""
    k = sympack.order_from_len(blocks.shape[1])
    w, vecs = torch.linalg.eigh(sympack.unpack(blocks, k, scaled=True))
    wi, wj = w[:, :, None], w[:, None, :]
    diff = wi - wj
    frac = (torch.clamp(wi, min=0.0) - torch.clamp(wj, min=0.0)) \
        / torch.where(diff != 0, diff, 1.0)
    bmat = torch.where((wi > 0) & (wj > 0), 1.0,
                       torch.where((wi <= 0) & (wj <= 0), 0.0, frac))
    vt = vecs.transpose(1, 2)

    def apply(db):
        with full_f32_matmul():
            dz = sympack.unpack(db, k, scaled=True)
            return sympack.pack(vecs @ (bmat * (vt @ dz @ vecs)) @ vt,
                                scaled=True)

    return apply


def _kkt_jacobian(grad: torch.Tensor, w: torch.Tensor,
                  coef: torch.Tensor) -> torch.Tensor:
    """DPi = P - q q^T / (grad^T q), q = P grad, P = I - coef w w^T: the
    solution of the differentiated KKT system of a projection onto a
    smooth boundary whose multiplier term mu hess g is c w w^T
    (coef = c / (1 + c ||w||^2) = (I + c w w^T)^-1's rank-one part).
    (count, 3) ``grad`` and ``w``, (count,) ``coef``; (count, 3, 3)."""
    eye = torch.eye(3, dtype=grad.dtype, device=grad.device)
    p = eye - coef[:, None, None] * w[:, :, None] * w[:, None, :]
    q = (p @ grad[:, :, None])[:, :, 0]
    den = (grad * q).sum(dim=1)
    den = torch.where(den > 0, den, 1.0)
    return p - q[:, :, None] * q[:, None, :] / den[:, None, None]


def _select(jac, cases):
    """``jac`` with each case's (mask, (count, 3, 3) or (3, 3) matrix)
    taking precedence in reverse order (the last case wins)."""
    for mask, mat in cases:
        jac = torch.where(mask[:, None, None], mat, jac)
    return jac


def exp_jacobian(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(count, 3, 3) DPi of the exp-cone projection at (count, 3) blocks
    ``v`` = (r0, s0, t0) whose projection is ``p`` = (r, s, t).

    Root case: p lies on t = s e^{r/s}; with rho = r/s, g(p) = s e^rho -
    t has grad g = kappa n with n = (1, 1 - rho, -e^-rho), kappa = e^rho
    for rho >= 0 and n = (e^rho, e^rho (1 - rho), -1), kappa = 1 below;
    mu hess g = c w w^T with w = (1, -rho, 0) and c = mu e^rho / s. The
    multiplier comes from the whole normal, v - p = mu kappa n, not from
    its t entry alone: next to the edge s = 0 (rho in the hundreds, where
    a whole open set of z projects to within 1e-19 of (0, 0, t0)) t - t0
    rounds to 0 while mu e^rho / s is about 1e18. A root at s = 0 exactly:
    diag(0, 0, step(t0)). In the cone: I; in the polar: 0; in the
    negative quadrant (r0, s0 <= 0): diag(1, 0, step(t0))."""
    r0, s0, t0 = v.unbind(1)
    r, s, t = p.unbind(1)
    e = math.e
    safe_s0 = torch.where(s0 != 0, s0, 1.0)
    safe_r0 = torch.where(r0 != 0, r0, 1.0)
    in_cone = ((s0 > 0) & (s0 * torch.exp(r0 / safe_s0) <= t0)) | \
        ((s0 == 0) & (r0 <= 0) & (t0 >= 0))
    in_polar = ((r0 > 0) & (r0 * torch.exp(s0 / safe_r0) <= -e * t0)) | \
        ((r0 == 0) & (s0 <= 0) & (t0 <= 0))
    neg_quad = (r0 <= 0) & (s0 <= 0)
    ss = torch.where(s > 0, s, 1.0)
    rho = r / ss
    er = torch.exp(-rho.abs())
    one = torch.ones_like(rho)
    grad = torch.where((rho >= 0)[:, None],
                       torch.stack([one, 1.0 - rho, -er], dim=1),
                       torch.stack([er, er * (1.0 - rho), -one], dim=1))
    w = torch.stack([one, -rho, torch.zeros_like(rho)], dim=1)
    mu_kappa = ((v - p) * grad).sum(dim=1) / (grad * grad).sum(dim=1)
    c = torch.clamp(mu_kappa * torch.where(rho >= 0, one, er) / ss,
                    min=0.0)
    coef = 1.0 / (1.0 / c + (w * w).sum(dim=1))
    jac = _kkt_jacobian(grad, w, coef)
    zero = torch.zeros(3, 3, dtype=v.dtype, device=v.device)
    nil = torch.zeros_like(one)
    edge = torch.diag_embed(torch.stack([nil, nil, _step(t0)], dim=1))
    quad = torch.diag_embed(torch.stack([one, nil, _step(t0)], dim=1))
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return _select(jac, ((s <= 0, edge), (neg_quad, quad),
                         (in_polar, zero), (in_cone, eye)))


def pow_jacobian(v: torch.Tensor, p: torch.Tensor,
                 alpha: float) -> torch.Tensor:
    """(count, 3, 3) DPi of the pow-cone projection (exponent ``alpha``)
    at (count, 3) blocks ``v`` = (x0, y0, z0) whose projection is ``p`` =
    (x, y, z).

    Blocks are scaled by their max-abs first, as the projection does (its
    Jacobian is scale-free). Root case: p lies on x^a y^(1-a) = |z| = r;
    g(p) = |z| - x^a y^(1-a) has x y grad g = (-a r y, -(1-a) r x,
    sign(z0) x y) = M n with n of max-abs 1, and mu hess g = mu a (1-a) r
    w w^T with w = (1/x, -1/y, 0), carried as w' = (y, -x, 0) = x y w, so
    c = mu a (1-a) r / (x y)^2. The multiplier comes from the whole
    normal, v - p = mu M n / (x y) (see :func:`exp_jacobian`). In the
    cone: I; in the polar: 0; at z0 = 0: diag(step(x0), step(y0), 0)."""
    a = float(alpha)
    tiny = cones._TINY[v.dtype]
    scl = torch.maximum(torch.maximum(v[:, 0].abs(), v[:, 1].abs()),
                        torch.clamp(v[:, 2].abs(), min=1e-30))[:, None]
    x0, y0, z0 = (v / scl).unbind(1)
    x, y, z = (p / scl).unbind(1)
    az = z0.abs()

    def pow_val(xx, yy):
        val = torch.exp(a * torch.log(torch.clamp(xx, min=tiny))
                        + (1.0 - a) * torch.log(torch.clamp(yy, min=tiny)))
        return torch.where((xx > 0) & (yy > 0), val, 0.0)

    in_cone = (x0 >= 0) & (y0 >= 0) & (pow_val(x0, y0) >= az)
    in_polar = (x0 <= 0) & (y0 <= 0) & \
        (pow_val(-x0 / a, -y0 / (1.0 - a)) >= az)
    z_zero = az == 0
    r = z.abs()
    xy = x * y
    grad = torch.stack([-a * r * y, -(1.0 - a) * r * x,
                        torch.sign(z0) * xy], dim=1)
    big = torch.clamp(grad.abs().amax(dim=1), min=tiny)
    grad = grad / big[:, None]
    w = torch.stack([y, -x, torch.zeros_like(x)], dim=1)
    mu_n = ((v / scl - p / scl) * grad).sum(dim=1) \
        / (grad * grad).sum(dim=1)
    # c = mu a (1-a) r / (x y)^2 with mu = x y mu_n / M
    c = torch.clamp((a * (1.0 - a)) * r * mu_n
                    / (big * torch.where(xy > 0, xy, 1.0)), min=0.0)
    coef = 1.0 / (1.0 / c + (w * w).sum(dim=1))
    jac = _kkt_jacobian(grad, w, coef)
    zero = torch.zeros(3, 3, dtype=v.dtype, device=v.device)
    axes = torch.diag_embed(torch.stack(
        [_step(x0), _step(y0), torch.zeros_like(x0)], dim=1))
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return _select(jac, ((z_zero, axes), (in_polar, zero),
                         (in_cone, eye)))


def _matrix_maps(jac: torch.Tensor) -> Tuple[Callable, Callable]:
    return (lambda db: (jac @ db[:, :, None])[:, :, 0],
            lambda db: (db[:, None, :] @ jac)[:, 0, :])


def _diagonal(f: Factor, seg: torch.Tensor, dual: bool):
    """DPi's diagonal on one factor's segment where DPi is diagonal there
    (zero and R+ factors), else None."""
    if f.total == 0 or f.kind == cones.ZERO:
        return torch.full_like(seg, 1.0 if dual else 0.0)
    if f.kind == cones.RPOS or (f.kind == cones.RSOC and f.dim == 1):
        return _step(seg)
    return None


def factor_dproj(f: Factor, seg: torch.Tensor, dual: bool
                 ) -> Tuple[torch.Tensor, Callable, Callable]:
    """(Pi(seg), v -> DPi v, w -> DPi^T w) for one factor's segment, the
    projection onto its cone (``dual``: its dual cone). Pi(seg) is the
    cone's own projection (kernel B for exp/pow and kernel J for a
    'jacobi' PSD factor on a CUDA tensor); the maps take and give
    segments of the same length."""
    d = _diagonal(f, seg, dual)
    if d is not None:
        lin = (lambda v: d * v)
        u = cones._project_factor(f, seg, dual) if f.kind == cones.ZERO \
            else torch.clamp(seg, min=0.0)
        return u, lin, lin
    blocks = seg.reshape(f.count, f.dim)

    def flat(fn):
        return lambda v: fn(v.reshape(f.count, f.dim)).reshape(f.total)

    if f.kind == cones.SOC:
        lin = flat(_soc_map(blocks))
        return cones._project_factor(f, seg, dual), lin, lin
    if f.kind == cones.RSOC:
        soc = _soc_map(_rot(blocks))
        lin = flat(lambda db: _rot(soc(_rot(db))))
        return cones._project_factor(f, seg, dual), lin, lin
    if f.kind == cones.PSD:
        lin = flat(_psd_map(blocks))
        return cones._project_factor(f, seg, dual), lin, lin
    if f.kind in (cones.EXP, cones.POW):
        from totsu_tpu_torch.ops.kernels import cone_proj
        vk = -blocks if dual else blocks
        p = cone_proj.cone_proj(vk.contiguous(), f.kind, f.alpha, False)
        jac = (exp_jacobian(vk, p) if f.kind == cones.EXP
               else pow_jacobian(vk, p, f.alpha))
        if dual:
            jac = torch.eye(3, dtype=jac.dtype, device=jac.device) - jac
        fwd, bwd = _matrix_maps(jac)
        u = blocks + p if dual else p
        return u.reshape(f.total), flat(fwd), flat(bwd)
    if f.kind == cones.CUSTOM:
        if dual:
            proj = f.dual_proj if f.dual_proj is not None \
                else (lambda xb: xb + f.proj(-xb))
        else:
            proj = f.proj
        out, vjp_fn = torch.func.vjp(proj, blocks)
        fwd = flat(lambda db: torch.func.jvp(proj, (blocks,), (db,))[1])
        bwd = flat(lambda db: vjp_fn(db)[0])
        return out.reshape(f.total), fwd, bwd
    raise ValueError(f"unknown cone kind {f.kind!r}")


@dataclasses.dataclass
class DProj:
    """Pi(z) and DPi(z) of the projection onto C = R^n x K* x R+ at one z:
    ``u`` = Pi(z), :meth:`apply` v -> DPi v, :meth:`apply_t` w -> DPi^T
    w. DPi is block diagonal: ``diag`` holds it where it is diagonal (the
    x and tau parts, zero and R+ factors; 0 elsewhere) and ``parts`` the
    other factors' maps, by offset into z."""
    u: torch.Tensor
    diag: torch.Tensor
    parts: List[Tuple[int, int, Callable, Callable]]

    def _map(self, v, which):
        out = self.diag * v
        for off, total, fwd, bwd in self.parts:
            out[off:off + total] = (fwd if which == 0 else bwd)(
                v[off:off + total])
        return out

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """DPi(z) v."""
        return self._map(v, 0)

    def apply_t(self, w: torch.Tensor) -> torch.Tensor:
        """DPi(z)^T w."""
        return self._map(w, 1)


def dproj_at(cone: ConeLayout, n: int, m: int, z: torch.Tensor) -> DProj:
    """Pi(z) and the per-factor data of DPi(z) for C = R^n x K* x R+ over
    z = (x (n), y (m), tau ()), built once (:class:`DProj`)."""
    if cone.dim != m or z.shape[0] != n + m + 1:
        raise ValueError(f"z of length {z.shape[0]} for n = {n}, m = {m} "
                         f"and a cone of dim {cone.dim}")
    us, diags = [z[:n]], [torch.ones_like(z[:n])]
    parts = []
    off = n
    for f in cone.factors:
        seg = z[off:off + f.total]
        u, fwd, bwd = factor_dproj(f, seg, True)
        d = _diagonal(f, seg, True)
        if d is None:
            d = torch.zeros_like(seg)
            parts.append((off, f.total, fwd, bwd))
        us.append(u)
        diags.append(d)
        off += f.total
    tau = z[n + m:]
    us.append(torch.clamp(tau, min=0.0))
    diags.append(_step(tau))
    return DProj(u=torch.cat(us), diag=torch.cat(diags), parts=parts)
