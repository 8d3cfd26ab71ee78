"""Bounded least squares as a QP (port of ``examples/leastsq_qp.py``).

Fit min ||F x - g||^2 s.t. 0 <= x <= 1, as a QP with P = F'F, q = -F'g
(a working version of the reference's stale experimental/leastsq_qp).
Validated against the unconstrained normal-equations solution when it
lies inside the box.

    python examples_torch/leastsq_qp.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import host, param, report, setup, tensors


def build(mrows=40, n=12, seed=3):
    """(F, g, P, q, G, h) in numpy: the data and the QP's blocks."""
    rng = np.random.default_rng(seed)
    f_mat = rng.normal(size=(mrows, n))
    x_true = rng.random(n)  # inside the box
    g_vec = f_mat @ x_true + 0.01 * rng.normal(size=mrows)
    p_mat = f_mat.T @ f_mat
    q = -f_mat.T @ g_vec
    eye = np.eye(n)
    g_ineq = np.concatenate([-eye, eye])
    h_ineq = np.concatenate([np.zeros(n), np.ones(n)])
    return f_mat, g_vec, p_mat, q, g_ineq, h_ineq


def main(mrows=40, n=12, seed=3, cpu=None):
    device, dtype, backend = setup(cpu)
    import totsu_tpu_torch as tt

    f_mat, g_vec, p_mat, q, g_ineq, h_ineq = build(mrows, n, seed)
    prob = tt.problems.qp(*tensors(device, dtype, p_mat, q, g_ineq, h_ineq))
    t0 = time.time()
    res = prob.solve_jit(param(dtype, max_iter=200_000, eps_acc=1e-6,
                               method="direct", f32={"eps_acc": 1e-4}))
    x = host(res.x)[:n]
    t_solve = time.time() - t0

    # oracle: if unconstrained optimum is in the box it must match
    x_ls, *_ = np.linalg.lstsq(f_mat, g_vec, rcond=None)
    inside = np.all((x_ls > 1e-6) & (x_ls < 1 - 1e-6))
    err = float(np.abs(x - np.clip(x_ls, 0, 1)).max()) if inside else np.nan
    rmse = float(np.linalg.norm(f_mat @ x - g_vec) / np.sqrt(mrows))
    report("leastsq_qp", res, t_solve,
           f"backend={backend} rmse={rmse:.4f} "
           + (f"vs_lstsq_err={err:.2e}" if inside else "(bounds active)"))
    if inside:
        assert err < 1e-3
    assert x.min() > -1e-4 and x.max() < 1 + 1e-4
    return rmse


if __name__ == "__main__":
    main()
