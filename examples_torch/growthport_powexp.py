"""Growth-optimal allocation via power + exponential cones (port of
``examples/growthport_powexp.py``).

Maximize the geometric mean of scenario portfolio returns (Kelly-style
growth rate) over the simplex, subject to an entropy diversification
budget:

    maximize   ( prod_i  r_i^T x )^(1/S)
    subject to sum_j x_j = 1,  x >= 0,
               sum_j x_j log x_j <= H        (negative entropy budget)

The geometric mean is a balanced binary tree of 3-D power cones
K_pow(1/2) = {(a, b, c) : sqrt(ab) >= |c|}; each entropy term
x_j log x_j <= q_j is one exponential-cone membership (-q_j, x_j, 1) in
K_exp. Self-check: objective and allocation against a scipy SLSQP solve
of the equivalent log-form NLP.

    python examples_torch/growthport_powexp.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import (host, layout, param, report, setup,
                                    tensors)


def make_returns(s_num, n, seed=0):
    """Positive gross returns around 1 with scenario spread, (S, n)."""
    rng = np.random.default_rng(seed)
    return 1.0 + 0.3 * rng.standard_normal((s_num, n)) ** 2 \
        - 0.1 * rng.random((s_num, n))


def build_problem(returns, h_budget):
    """Conic data (c, A, b, cone spec, index of the tree root) in numpy;
    ``layout(spec)`` is the cone. ``returns`` (S, n), S a power of two.
    Variables z = [x (n) | q (n) | tree nodes (S - 1, root last)]; the
    slack s = b - A z lies in the cone."""
    s_num, n = returns.shape
    assert s_num & (s_num - 1) == 0, "scenario count must be a power of 2"
    nv = 2 * n + s_num - 1
    rows, bs = [], []

    def row(coeffs, bval):
        r = np.zeros(nv)
        for idx, v in coeffs:
            r[idx] = v
        rows.append(r)
        bs.append(bval)

    row([(j, 1.0) for j in range(n)], 1.0)          # zero: sum x = 1
    for j in range(n):
        row([(j, -1.0)], 0.0)                       # R+: x >= 0
    row([(n + j, 1.0) for j in range(n)], h_budget)  # R+: H - sum q >= 0
    # power-cone tree: leaves are scenario returns y_i = returns[i] @ x;
    # level by level, node_k in K_pow(1/2) over its two children
    leaves = [("ret", i) for i in range(s_num)]
    k = 0
    while len(leaves) > 1:
        nxt = []
        for pair in zip(leaves[0::2], leaves[1::2]):
            for kind, idx in pair:
                if kind == "ret":
                    row([(j, -returns[idx, j]) for j in range(n)], 0.0)
                else:
                    row([(2 * n + idx, -1.0)], 0.0)
            row([(2 * n + k, -1.0)], 0.0)
            nxt.append(("node", k))
            k += 1
        leaves = nxt
    for j in range(n):                              # (-q_j, x_j, 1) in K_exp
        row([(n + j, 1.0)], 0.0)
        row([(j, -1.0)], 0.0)
        row([], 1.0)
    c = np.zeros(nv)
    c[2 * n + k - 1] = -1.0   # maximize the root = the geometric mean
    spec = [("zero", (1,)), ("rpos", (n + 1,)), ("powc", (0.5, k)),
            ("expc", (n,))]
    return c, np.asarray(rows), np.asarray(bs), spec, 2 * n + k - 1


def make_growth(s_num=64, n=50, h_budget=-2.0, seed=0):
    """(returns, c, A, b, cone spec, root): the data of ``main``."""
    returns = make_returns(s_num, n, seed)
    return (returns,) + build_problem(returns, h_budget)


def scipy_oracle(returns, h_budget):
    """Log-form NLP solved by SLSQP: the objective-parity oracle."""
    from scipy.optimize import minimize
    s_num, n = returns.shape

    def negloggrowth(x):
        return -np.mean(np.log(returns @ x))

    cons = [
        {"type": "eq", "fun": lambda x: x.sum() - 1.0},
        {"type": "ineq",
         "fun": lambda x: h_budget - np.sum(x * np.log(np.maximum(x, 1e-12)))},
    ]
    r = minimize(negloggrowth, np.full(n, 1.0 / n), method="SLSQP",
                 bounds=[(0.0, 1.0)] * n, constraints=cons,
                 options={"maxiter": 500, "ftol": 1e-12})
    return np.exp(-r.fun), r.x


def main(n=6, s_num=4, h_budget=-1.2, seed=0, cpu=None):
    device, dtype, backend = setup(cpu)
    import totsu_tpu_torch as tt

    returns, c, a, b, spec, root = make_growth(s_num, n, h_budget, seed)
    t0 = time.time()
    res = tt.solve(*tensors(device, dtype, c, a, b), layout(spec),
                   param(dtype, max_iter=300_000, eps_acc=1e-7,
                         f32={"eps_acc": 1e-4}))
    sol = host(res.x)
    t_solve = time.time() - t0

    x = sol[:n]
    growth = float(sol[root])
    g_ref, x_ref = scipy_oracle(returns, h_budget)
    report(f"growthport_powexp {backend}", res, t_solve,
           f"growth={growth:.6f} oracle={g_ref:.6f}")
    print("  alloc      ", np.round(x, 4))
    print("  oracle     ", np.round(x_ref, 4))
    # self-checks: simplex feasibility, entropy budget, objective parity
    assert abs(x.sum() - 1.0) < 1e-5 and (x > -1e-6).all()
    ent = float(np.sum(x * np.log(np.maximum(x, 1e-12))))
    assert ent <= h_budget + 1e-4, (ent, h_budget)
    assert abs(growth - g_ref) < 2e-4 * (1.0 + abs(g_ref)), (growth, g_ref)
    # the tree root actually equals the geometric mean of the returns
    gm = float(np.exp(np.mean(np.log(returns @ x))))
    assert abs(growth - gm) < 1e-4, (growth, gm)
    return growth


if __name__ == "__main__":
    main()
