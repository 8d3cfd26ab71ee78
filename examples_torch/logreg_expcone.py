"""L1-regularized logistic regression via exponential cones (port of
``examples/logreg_expcone.py``).

    minimize_w  sum_i log(1 + exp(-y_i x_i^T w)) + lam ||w||_1

Each softplus epigraph ``log(1 + e^z) <= t`` is exactly two exp-cone
memberships plus one budget row:

    e^{z-t} <= u,   e^{-t} <= v,   u + v <= 1

i.e. ``(z - t, 1, u) in K_exp``, ``(-t, 1, v) in K_exp``, the standard
conic reduction of the logistic loss (as in CVXPY/ECOS). The L1 term uses
the usual |w_j| <= a_j split into two R+ rows. Self-check: scipy SLSQP
on the smooth bound-constrained equivalent.

    python examples_torch/logreg_expcone.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import (host, layout, param, report, setup,
                                    tensors)


def make_data(m, n, seed=3):
    """(x (m, n), y (m,) in {-1, 1}): samples of a sparse linear
    classifier with label noise."""
    rng = np.random.default_rng(seed)
    w_true = np.concatenate([rng.normal(size=n // 2) * 2.0,
                             np.zeros(n - n // 2)])
    x = rng.normal(size=(m, n))
    y = np.where(x @ w_true + 0.3 * rng.normal(size=m) > 0, 1.0, -1.0)
    return x, y


def build(x, y, lam):
    """Conic data (c, A, b, cone spec) in numpy; ``layout(spec)`` is the
    cone. Variables z = [w (n) | t (m) | u (m) | v (m) | a (n)]: the
    budgets 1 - u_i - v_i >= 0 and the L1 splits a_j -+ w_j >= 0 (R+),
    then the exp blocks (z_i - t_i, 1, u_i) with z_i = -y_i x_i.w, then
    (-t_i, 1, v_i)."""
    m, n = x.shape
    nv = 2 * n + 3 * m
    it, iu = n + np.arange(m), n + m + np.arange(m)
    iv, ia = n + 2 * m + np.arange(m), n + 3 * m + np.arange(n)
    iw = np.arange(n)
    a = np.zeros((m + 2 * n + 6 * m, nv))
    b = np.zeros(m + 2 * n + 6 * m)
    rows = np.arange(m)
    a[rows, iu] = 1.0                          # 1 - u_i - v_i >= 0
    a[rows, iv] = 1.0
    b[:m] = 1.0
    rj = m + 2 * np.arange(n)
    a[rj, ia], a[rj, iw] = -1.0, 1.0           # a_j - w_j >= 0
    a[rj + 1, ia], a[rj + 1, iw] = -1.0, -1.0  # a_j + w_j >= 0
    e0 = m + 2 * n + 3 * rows                  # (z_i - t_i, 1, u_i)
    a[e0, :n] = y[:, None] * x
    a[e0, it] = 1.0
    b[e0 + 1] = 1.0
    a[e0 + 2, iu] = -1.0
    e1 = m + 2 * n + 3 * m + 3 * rows          # (-t_i, 1, v_i)
    a[e1, it] = 1.0
    b[e1 + 1] = 1.0
    a[e1 + 2, iv] = -1.0
    c = np.zeros(nv)
    c[n:n + m] = 1.0          # sum t_i
    c[n + 3 * m:] = lam       # lam * sum a_j
    return c, a, b, [("rpos", (m + 2 * n,)), ("expc", (2 * m,))]


def make_logreg(m, n, lam=0.1, seed=3):
    """(x, y, c, A, b, cone spec): the data of ``main``."""
    x, y = make_data(m, n, seed)
    return (x, y) + build(x, y, lam)


def scipy_oracle(x, y, lam):
    from scipy.optimize import minimize
    m, n = x.shape

    def f(z):
        w, a = z[:n], z[n:]
        return float(np.sum(np.logaddexp(0.0, -y * (x @ w))) + lam * a.sum())

    cons = [{"type": "ineq", "fun": lambda z, j=j, s=s:
             z[n + j] - s * z[j]} for j in range(n) for s in (1.0, -1.0)]
    r = minimize(f, np.zeros(2 * n), method="SLSQP", constraints=cons,
                 options={"maxiter": 1000, "ftol": 1e-12})
    return r.fun, r.x[:n]


def main(m=40, n=8, lam=0.1, seed=3, cpu=None):
    device, dtype, backend = setup(cpu)
    import totsu_tpu_torch as tt

    x, y, c, a, b, spec = make_logreg(m, n, lam, seed)
    t0 = time.time()
    res = tt.solve(*tensors(device, dtype, c, a, b), layout(spec),
                   param(dtype, max_iter=500_000, eps_acc=1e-6,
                         profile="fast", f32={"eps_acc": 1e-4}))
    w = host(res.x)[:n]
    t_solve = time.time() - t0

    obj = float(np.sum(np.logaddexp(0.0, -y * (x @ w)))
                + lam * np.sum(np.abs(w)))
    obj_ref, w_ref = scipy_oracle(x, y, lam)
    report("logreg_expcone", res, t_solve,
           f"backend={backend} m={m} n={n} obj={obj:.6f} "
           f"oracle={obj_ref:.6f}")
    # objective parity with the NLP oracle; the conic solution must also
    # classify the training set at least as well
    assert obj <= obj_ref * (1.0 + 1e-3) + 1e-6
    acc = float(np.mean(np.sign(x @ w) == y))
    assert acc >= 0.8
    return obj


if __name__ == "__main__":
    main()
