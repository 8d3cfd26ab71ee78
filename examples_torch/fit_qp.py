"""Learning through optimization: fit QP parameters to observed solutions
(port of ``examples/fit_qp.py``).

The cvxpylayers/diffcp workflow on the port's differentiable layer: a
ground-truth QP

    minimize (1/2) x' P* x + q*' x   s.t.  -1 <= x <= 1

produces observed solutions for a family of shifted costs; the diagonal
of P* and q* are recovered by gradient descent (Adam) on the
solution-matching loss, with gradients flowing through both the
``problems.qp`` reduction (dP and dq enter through the P^(1/2) eigh and
the stacked conic data) and the implicit-differentiation rule of
``make_differentiable_solver``. Each evaluation solves every shift in one
lockstep batch (the JAX example's ``jax.vmap``).

    python examples_torch/fit_qp.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import setup


def main(n=4, n_obs=6, steps=150, cpu=None):
    """Fit, self-check and print; returns (first loss, final loss,
    held-out max error, fitted theta)."""
    device, dtype, backend = setup(cpu)
    import torch
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.diff import make_differentiable_solver

    t0 = time.time()
    rng = np.random.default_rng(0)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    p_true = t(rng.random(n) + 0.5)      # diagonal of P*
    q_true = t(rng.normal(size=n) * 0.3)
    shifts = t(rng.normal(size=(n_obs, n)) * 0.2)

    eye = np.eye(n)
    g = t(np.concatenate([eye, -eye]))
    h = t(np.ones(2 * n))
    lay = tt.problems.qp(torch.diag(p_true), q_true, g=g, h=h).cone
    param = tt.SolverParam(max_iter=200_000, method="direct",
                           eps_acc=1e-9 if dtype == torch.float64 else 1e-5)
    solver = make_differentiable_solver(lay, param)

    def solve_x(pdiag, q, shift):
        """x of every shift's QP, one lockstep batch: (B, n)."""
        probs = [tt.problems.qp(torch.diag(pdiag), q + s, g=g, h=h)
                 for s in shift]
        x, _ = solver(torch.stack([p.c for p in probs]),
                      torch.stack([p.a.a for p in probs]),
                      torch.stack([p.b for p in probs]))
        return x[:, :n]

    with torch.no_grad():
        x_obs = solve_x(p_true, q_true, shifts)

    def unpack(theta):
        # softplus + 0.1 keeps P positive
        return torch.nn.functional.softplus(theta[:n]) + 0.1, theta[n:]

    def loss(theta):
        xs = solve_x(*unpack(theta), shifts)
        return torch.mean(torch.sum((xs - x_obs) ** 2, dim=-1))

    # init with DISTINCT P eigenvalues: the qp() reduction takes P^(1/2)
    # via eigh, whose derivative is undefined (NaN) at exactly repeated
    # eigenvalues (theta = 0 would make P = c I, the fully degenerate
    # point)
    theta = torch.cat([t(rng.normal(size=n) * 0.3), t(np.zeros(n))])
    # Adam: the loss surface mixes soft (q) and stiff (P) directions
    mt = torch.zeros_like(theta)
    vt = torch.zeros_like(theta)
    lr, b1, b2 = 0.1, 0.9, 0.999
    l0 = None
    for k in range(steps):
        th = theta.clone().requires_grad_(True)
        lv = loss(th)
        (gv,) = torch.autograd.grad(lv, th)
        if l0 is None:
            l0 = float(lv.detach())
        mt = b1 * mt + (1 - b1) * gv
        vt = b2 * vt + (1 - b2) * gv * gv
        mh = mt / (1 - b1 ** (k + 1))
        vh = vt / (1 - b2 ** (k + 1))
        theta = theta - lr * mh / (torch.sqrt(vh) + 1e-8)
    with torch.no_grad():
        l_fin = float(loss(theta))
        p_fit, q_fit = unpack(theta)
        # self-check: the fitted parameters reproduce held-out solutions
        s_new = t(rng.normal(size=(3, n)) * 0.2)
        x_t = solve_x(p_true, q_true, s_new)
        x_f = solve_x(p_fit, q_fit, s_new)
    held = float(torch.max(torch.abs(x_t - x_f)))
    assert l_fin < 1e-2 * l0, (l0, l_fin)
    assert held < 5e-2, held
    print(f"[fit_qp] OK on {backend}: loss {l0:.2e} -> {l_fin:.2e}, "
          f"held-out max err {held:.2e}, {time.time() - t0:.1f}s")
    return l0, l_fin, held, theta


if __name__ == "__main__":
    main()
