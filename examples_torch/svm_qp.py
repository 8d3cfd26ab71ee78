"""Hard-margin Gaussian-kernel SVM dual as a QP (port of
``examples/svm_qp.py``).

After ref examples/svm_qp/src/main.rs:47-120: l = 50 ring-labeled random
points; P_ij = y_i y_j K(x_i, x_j); maximize sum(alpha) - 1/2 a'Pa subject
to alpha >= 0 and the single equality sum(alpha_i y_i) = 0; bias recovered
from support vectors afterwards.

    python examples_torch/svm_qp.py [--cpu] [--plot]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch import _plot
from examples_torch._common import host, param, report, setup, tensors
from examples_torch.l1reg_lp import gaussian_kernel


def build(l=50, seed=10_000):
    rng = np.random.default_rng(seed)
    x = rng.random((l, 2))
    r = np.hypot(x[:, 0] - 0.5, x[:, 1] - 0.5)
    y = np.where((r > 0.25) & (r < 0.4), 1.0, -1.0)

    kmat = gaussian_kernel(x, x)
    p_mat = np.outer(y, y) * kmat
    q = -np.ones(l)
    g = -np.eye(l)
    h = np.zeros(l)
    a = y[None, :]
    b = np.zeros(1)
    return p_mat, q, g, h, a, b, x, y, kmat


def main(l=50, cpu=None):
    device, dtype, backend = setup(cpu)
    import totsu_tpu_torch as tt

    p_mat, q, g, h, a, b, x, y, kmat = build(l)
    prob = tt.problems.qp(*tensors(device, dtype, p_mat, q, g, h, a, b))

    t0 = time.time()
    res = prob.solve_jit(param(dtype, max_iter=200_000, eps_acc=1e-3))
    alpha = host(res.x)[:l]
    t_solve = time.time() - t0

    # bias from support vectors (ref main.rs:107-117)
    sv = alpha > 1e-4
    wx = (alpha * y) @ kmat
    bias = float(np.mean(y[sv] - wx[sv])) if sv.any() else 0.0
    # self-check: training accuracy of the recovered classifier
    pred = np.sign(wx + bias)
    acc = float((pred == y).mean())
    obj = float(0.5 * alpha @ p_mat @ alpha + q @ alpha)
    report("svm_qp", res, t_solve,
           f"backend={backend} obj={obj:.6f} sv={int(sv.sum())} acc={acc:.3f}")
    assert acc >= 0.95, acc

    if _plot.enabled():
        # decision-boundary contour (the reference's ContourSeries plot)
        plt = _plot.pyplot()
        from totsu_tpu_torch.utils import chain_segments, contour_segments
        xs = np.linspace(0, 1, 80)
        ys = np.linspace(0, 1, 80)
        gx, gy = np.meshgrid(xs, ys)
        grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
        f = gaussian_kernel(grid, x) @ (alpha * y) + bias
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.contourf(gx, gy, f.reshape(gx.shape), levels=[-1e9, 0, 1e9],
                    colors=["#cce", "#ecc"], alpha=0.6)
        # decision boundary via the library's own marching-squares series
        # (the reference's utils2::ContourSeries role)
        for line in chain_segments(
                contour_segments(xs, ys, f.reshape(gx.shape), level=0.0)):
            ax.plot(line[:, 0], line[:, 1], "k-", lw=1.5)
        ax.scatter(x[:, 0], x[:, 1], c=y, cmap="coolwarm",
                   edgecolors="k", s=25)
        ax.set_title("svm_qp: kernel SVM decision boundary")
        _plot.save(fig, "svm_qp.png")
    return obj


if __name__ == "__main__":
    main()
