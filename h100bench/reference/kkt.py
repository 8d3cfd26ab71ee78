"""How far an answer (x, y) of the benchmark's dense LP is from optimal,
in float64, from the inputs alone.

For min c^T x s.t. G x <= h, -box <= x <= box, with y the duals of the
rows [G; I; -I] (the solver's sign convention: at the optimum y >= 0,
[G; I; -I]^T y + c = 0 and c^T x + h_full^T y = 0):

* ``pri``: the norm of the rows' violation, over 1 + ||h_full||;
* ``dual``: ||[G; I; -I]^T y + c|| over 1 + ||c||;
* ``ycone``: ||min(y, 0)|| over 1 + ||c||, y's distance from its cone;
* ``gap``: |c^T x + h_full^T y| over 1 + |c^T x| + |h_full^T y|.

``pri``, ``dual`` and ``gap`` are the solver's own criteria
(``eps_acc``), with the slack taken from x itself rather than from the
solver's iterate, so a primal violation here is at most the solver's
primal residual. With ``ycone`` the four together certify x: a y in its
cone that meets the dual equation bounds c^T x from below up to the
residuals, whatever point is optimal.
"""

import torch


def residuals(g, h, c, box: float, x, y):
    """{'pri', 'dual', 'ycone', 'gap'}, each (B,), for batched G (B, m, n),
    h (B, m), c (B, n), x (B, n), y (B, m + 2n)."""
    g, h, c, x, y = (t.to(torch.float64) for t in (g, h, c, x, y))
    m, n = g.shape[1], g.shape[2]
    gx = torch.bmm(g, x.unsqueeze(-1)).squeeze(-1)
    viol = torch.cat([gx - h, x - box, -x - box], dim=-1).clamp(min=0.0)
    norm_h = torch.sqrt((h * h).sum(-1) + 2 * n * box * box)
    pri = torch.linalg.vector_norm(viol, dim=-1) / (1.0 + norm_h)
    y1, y2, y3 = y[:, :m], y[:, m:m + n], y[:, m + n:]
    gty = torch.bmm(g.transpose(1, 2), y1.unsqueeze(-1)).squeeze(-1) \
        + y2 - y3
    one_c = 1.0 + torch.linalg.vector_norm(c, dim=-1)
    dual = torch.linalg.vector_norm(gty + c, dim=-1) / one_c
    ycone = torch.linalg.vector_norm(y.clamp(max=0.0), dim=-1) / one_c
    cx = (c * x).sum(-1)
    hy = (h * y1).sum(-1) + box * (y2.sum(-1) + y3.sum(-1))
    gap = (cx + hy).abs() / (1.0 + cx.abs() + hy.abs())
    return {"pri": pri, "dual": dual, "ycone": ycone, "gap": gap}
