"""L1-regularized L1-error Gaussian-kernel regression as an LP (port of
``examples/l1reg_lp.py``).

After ref examples/l1reg_lp/src/main.rs:45-123: n = 3l+1 variables
(z, alpha, beta, bias), m = 4l inequalities encoding
|y_i - (K alpha)_i - bias| <= z_i and |alpha_i| <= beta_i, objective
sum(z) + lambda * sum(beta), Gaussian kernel sigma^2 = 1/8, lambda = 0.2,
eps_acc = 1e-3.

    python examples_torch/l1reg_lp.py [--cpu] [--plot]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch import _plot
from examples_torch._common import host, param, report, setup, tensors


def gaussian_kernel(xa, xb, sigma_sq=1.0 / 8.0):
    d2 = ((xa[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / sigma_sq)


def build(l=20, lam=0.2, seed=0):
    """(c, G, h, x, y, K) in numpy: the LP min c.v s.t. G v <= h."""
    rng = np.random.default_rng(seed)
    x = rng.random((l, 2))
    y = np.cos(5.0 * x[:, 0]) * np.cos(7.0 * x[:, 1])

    kmat = gaussian_kernel(x, x)
    n = 3 * l + 1
    m = 4 * l

    c = np.zeros(n)
    c[:l] = 1.0          # z: L1 error
    c[2 * l:3 * l] = lam  # beta: L1 regularization

    g = np.zeros((m, n))
    eye = np.eye(l)
    # rows 0..l:   K alpha + bias - z <= y
    g[:l, :l] = -eye
    g[:l, l:2 * l] = kmat
    g[:l, 3 * l] = 1.0
    # rows l..2l: -K alpha - bias - z <= -y
    g[l:2 * l, :l] = -eye
    g[l:2 * l, l:2 * l] = -kmat
    g[l:2 * l, 3 * l] = -1.0
    # rows 2l..3l: alpha - beta <= 0
    g[2 * l:3 * l, l:2 * l] = eye
    g[2 * l:3 * l, 2 * l:3 * l] = -eye
    # rows 3l..4l: -alpha - beta <= 0
    g[3 * l:4 * l, l:2 * l] = -eye
    g[3 * l:4 * l, 2 * l:3 * l] = -eye

    h = np.concatenate([y, -y, np.zeros(2 * l)])
    return c, g, h, x, y, kmat


def main(l=20, cpu=None):
    device, dtype, backend = setup(cpu)
    import totsu_tpu_torch as tt

    c, g, h, x, y, kmat = build(l)
    prob = tt.problems.lp(*tensors(device, dtype, c, g, h))

    t0 = time.time()
    res = prob.solve_jit(param(dtype, max_iter=200_000, eps_acc=1e-3))
    sol = host(res.x)
    t_solve = time.time() - t0

    z, alpha, beta, bias = (sol[:l], sol[l:2 * l], sol[2 * l:3 * l],
                            sol[3 * l])
    obj = float(c @ sol)
    # self-check: objective equals measured L1 error + lambda*||alpha||_1
    pred = kmat @ alpha + bias
    direct = np.abs(y - pred).sum() + 0.2 * np.abs(alpha).sum()
    report("l1reg_lp", res, t_solve,
           f"backend={backend} obj={obj:.6f} direct={direct:.6f}")
    assert abs(obj - direct) < 2e-2

    if _plot.enabled():
        # contour of the fitted kernel regressor over [0,1]^2 with samples
        # (the reference's plot.svg, main.rs:127-201)
        plt = _plot.pyplot()
        gx, gy = np.meshgrid(np.linspace(0, 1, 60), np.linspace(0, 1, 60))
        grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
        fhat = gaussian_kernel(grid, x) @ alpha + bias
        fig, ax = plt.subplots(figsize=(5, 4))
        cs = ax.contourf(gx, gy, fhat.reshape(gx.shape), levels=12,
                         cmap="coolwarm")
        fig.colorbar(cs)
        ax.scatter(x[:, 0], x[:, 1], c=y, cmap="coolwarm",
                   edgecolors="k", s=30)
        ax.set_title("l1reg_lp: kernel regression fit")
        _plot.save(fig, "l1reg_lp.png")
    return obj


if __name__ == "__main__":
    main()
