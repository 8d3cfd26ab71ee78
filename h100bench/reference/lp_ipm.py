"""Plain reference for the benchmark's LPs: a primal-dual interior-point
method (Mehrotra's predictor-corrector) in float64, in plain PyTorch.

The LP is the one the instance generator makes (``h100bench/instances.py``):

    minimize    c^T x
    subject to  G x <= h,   -box <= x <= box

with dual variables z >= 0 for the rows of G and of the box. At the
optimum G^T z + c = 0 (z over the full row set [G; I; -I]) and
c^T x + h_full^T z = 0, the signs the solver's embedding uses for its
(x, y).

Every lane of a batch is solved at once: G (B, m, n), h (B, m), c (B, n).
The box rows are kept apart as a diagonal, so the normal matrix is
G^T W G + diag(w_up + w_lo), factored by Cholesky. Nothing here imports
the program under test; it only reads the same f32 inputs, widened to
float64.
"""

import torch


def solve_lp(g, h, c, box: float, tol: float = 1e-9, max_iter: int = 100):
    """Solve every lane of the batch to relative KKT residuals under
    ``tol``; returns ``(x, z, obj, iters, ok)``: x (B, n), z (B, m + 2n)
    the duals of [G; I; -I], obj (B,) = c^T x, the IPM steps taken, and
    ok (B,) whether the lane met ``tol``.

    Each lane returns the iterate with its smallest residual, and stops
    stepping once it meets ``tol`` or once mu has fallen to round-off
    (where float64's residual floor, about 1e-9 on ill-conditioned lanes,
    lies above ``tol`` and further steps only lose accuracy)."""
    g = g.to(torch.float64)
    h = h.to(torch.float64)
    c = c.to(torch.float64)
    bsz, m, n = g.shape
    dev = g.device
    ub = torch.full((bsz, n), float(box), dtype=torch.float64, device=dev)
    x = torch.zeros(bsz, n, dtype=torch.float64, device=dev)
    s1 = torch.ones(bsz, m, dtype=torch.float64, device=dev)
    z1 = torch.ones_like(s1)
    s2 = torch.ones(bsz, n, dtype=torch.float64, device=dev)
    s3 = torch.ones_like(s2)
    z2 = torch.ones_like(s2)
    z3 = torch.ones_like(s2)
    rows = m + 2 * n
    norm_h = torch.sqrt((h * h).sum(-1) + 2 * (ub * ub).sum(-1))
    norm_c = torch.linalg.vector_norm(c, dim=-1)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    best = torch.full((bsz,), float("inf"), dtype=torch.float64, device=dev)
    best_x = x.clone()
    best_z = torch.cat([z1, z2, z3], dim=-1)
    eye = torch.eye(n, dtype=torch.float64, device=dev)

    def gmv(v):
        return torch.bmm(g, v.unsqueeze(-1)).squeeze(-1)

    def gtmv(v):
        return torch.bmm(g.transpose(1, 2), v.unsqueeze(-1)).squeeze(-1)

    def step_to_boundary(v, dv):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
        return ratio.amin(-1)

    it = 0
    for it in range(max_iter + 1):
        rd = gtmv(z1) + z2 - z3 + c
        rp1 = gmv(x) + s1 - h
        rp2 = x + s2 - ub
        rp3 = -x + s3 - ub
        cx = (c * x).sum(-1)
        hz = (h * z1).sum(-1) + (ub * (z2 + z3)).sum(-1)
        pri = torch.sqrt((rp1 * rp1).sum(-1) + (rp2 * rp2).sum(-1)
                         + (rp3 * rp3).sum(-1)) / (1.0 + norm_h)
        dua = torch.linalg.vector_norm(rd, dim=-1) / (1.0 + norm_c)
        gap = (cx + hz).abs() / (1.0 + cx.abs() + hz.abs())
        worst = torch.maximum(torch.maximum(pri, dua), gap)
        better = worst < best
        best = torch.where(better, worst, best)
        best_x = torch.where(better[:, None], x, best_x)
        best_z = torch.where(better[:, None],
                             torch.cat([z1, z2, z3], dim=-1), best_z)
        mu = ((s1 * z1).sum(-1) + (s2 * z2).sum(-1)
              + (s3 * z3).sum(-1)) / rows
        done = done | (worst <= tol) | (mu <= 1e-15 * (1.0 + cx.abs()))
        if bool(done.all()) or it == max_iter:
            break
        w1, w2, w3 = z1 / s1, z2 / s2, z3 / s3
        normal = torch.bmm(g.transpose(1, 2), g * w1.unsqueeze(-1)) \
            + torch.diag_embed(w2 + w3)
        chol, info = torch.linalg.cholesky_ex(normal)
        # a lane already at tol may have lost definiteness to round-off:
        # it keeps its point (step 0) and an identity factor
        bad = info != 0
        if bool(bad.any()):
            chol = torch.where(bad[:, None, None], eye.expand_as(chol), chol)

        def newton(rc1, rc2, rc3):
            t1 = (rc1 + z1 * rp1) / s1
            t2 = (rc2 + z2 * rp2) / s2
            t3 = (rc3 + z3 * rp3) / s3
            rhs = -rd - (gtmv(t1) + t2 - t3)
            dx = torch.cholesky_solve(rhs.unsqueeze(-1), chol).squeeze(-1)
            ds1 = -rp1 - gmv(dx)
            ds2 = -rp2 - dx
            ds3 = -rp3 + dx
            dz1 = (rc1 - z1 * ds1) / s1
            dz2 = (rc2 - z2 * ds2) / s2
            dz3 = (rc3 - z3 * ds3) / s3
            return dx, (ds1, ds2, ds3), (dz1, dz2, dz3)

        def alphas(ds, dz):
            ap = torch.stack([step_to_boundary(s, d) for s, d in
                              zip((s1, s2, s3), ds)]).amin(0)
            ad = torch.stack([step_to_boundary(zz, d) for zz, d in
                              zip((z1, z2, z3), dz)]).amin(0)
            return ap.clamp(max=1.0), ad.clamp(max=1.0)

        _, ds_a, dz_a = newton(-s1 * z1, -s2 * z2, -s3 * z3)
        ap, ad = alphas(ds_a, dz_a)
        mu_aff = sum(((s + ap[:, None] * d) * (zz + ad[:, None] * e)).sum(-1)
                     for s, d, zz, e in zip((s1, s2, s3), ds_a,
                                            (z1, z2, z3), dz_a)) / rows
        sigma = (mu_aff / mu).clamp(min=0.0, max=1.0) ** 3
        sm = (sigma * mu)[:, None]
        dx, ds, dz = newton(-s1 * z1 - ds_a[0] * dz_a[0] + sm,
                            -s2 * z2 - ds_a[1] * dz_a[1] + sm,
                            -s3 * z3 - ds_a[2] * dz_a[2] + sm)
        ap, ad = alphas(ds, dz)
        keep = (~done) & (~bad)
        ap = torch.where(keep, (0.99 * ap).clamp(max=1.0), 0.0)[:, None]
        ad = torch.where(keep, (0.99 * ad).clamp(max=1.0), 0.0)[:, None]
        x = x + ap * dx
        s1, s2, s3 = s1 + ap * ds[0], s2 + ap * ds[1], s3 + ap * ds[2]
        z1, z2, z3 = z1 + ad * dz[0], z2 + ad * dz[1], z3 + ad * dz[2]
    return best_x, best_z, (c * best_x).sum(-1), it, best <= tol
