"""Box-design geometric program (port of ``examples/boxdesign_gp.py``).

Maximize the volume of a box h x w x d subject to a wall-area budget, a
floor-area budget and aspect-ratio limits (Boyd, Kim, Vandenberghe &
Hassibi, "A tutorial on geometric programming", 2007, section 2.1):

    maximize    h w d
    subject to  2(hw + hd) <= A_wall,     w d <= A_floor,
                alpha <= h/w <= beta,     gamma <= d/w <= delta.

In posynomial form this is min (hwd)^-1 with four monomial and two
posynomial constraints, which ``problems.gp`` reduces to exp cones
(log-sum-exp epigraphs). Self-check: scipy SLSQP on the log-form NLP.

    python examples_torch/boxdesign_gp.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import host, param, report, setup


def build(a_wall=100.0, a_floor=10.0, alpha=0.5, beta=2.0,
          gamma=0.5, delta=2.0):
    """term/eq data for problems.gp; variables y = log (h, w, d)."""
    # objective: (hwd)^-1
    term_c = [[1.0]]
    term_a = [[[-1.0, -1.0, -1.0]]]
    # wall area: (2/A) hw + (2/A) hd <= 1
    term_c.append([2.0 / a_wall, 2.0 / a_wall])
    term_a.append([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]])
    # floor area: (1/A) wd <= 1
    term_c.append([1.0 / a_floor])
    term_a.append([[0.0, 1.0, 1.0]])
    # aspect ratios as monomial inequalities: alpha w/h <= 1 is posynomial
    for coef, row in ((alpha, [-1.0, 1.0, 0.0]),
                      (1.0 / beta, [1.0, -1.0, 0.0]),
                      (gamma, [0.0, 1.0, -1.0]),
                      (1.0 / delta, [0.0, -1.0, 1.0])):
        term_c.append([coef])
        term_a.append([row])
    return term_c, term_a


def scipy_oracle(term_c, term_a):
    from scipy.optimize import minimize

    def lse(y, ci, ai):
        return np.log(np.sum(ci * np.exp(np.asarray(ai) @ y)))

    cons = [{"type": "ineq",
             "fun": (lambda y, ci=np.asarray(ci), ai=np.asarray(ai):
                     -lse(y, ci, ai))}
            for ci, ai in zip(term_c[1:], term_a[1:])]
    r = minimize(lambda y: lse(y, np.asarray(term_c[0]),
                               np.asarray(term_a[0])),
                 np.zeros(3), method="SLSQP", constraints=cons,
                 options={"maxiter": 500, "ftol": 1e-12})
    return np.exp(r.x), np.exp(-r.fun)


def main(cpu=None):
    device, dtype, backend = setup(cpu)
    import totsu_tpu_torch as tt

    term_c, term_a = build()
    prob, meta = tt.problems.gp(term_c, term_a, device=device, dtype=dtype)
    t0 = time.time()
    # f32: at eps_acc 1e-4 the wall-area row is 0.1% over its budget
    res = prob.solve(param(dtype, max_iter=500_000, eps_acc=1e-6,
                           f32={"eps_acc": 1e-5}))
    hwd = np.exp(host(res.x)[:3])
    t_solve = time.time() - t0

    vol = float(np.prod(hwd))
    x_ref, vol_ref = scipy_oracle(term_c, term_a)
    report("boxdesign_gp", res, t_solve,
           f"backend={backend} h,w,d={np.round(hwd, 4)} vol={vol:.4f} "
           f"oracle_vol={vol_ref:.4f}")
    # self-checks: constraints hold, volume matches the NLP oracle
    h, w, d = hwd
    assert 2 * (h * w + h * d) <= 100.0 * (1 + 1e-3)
    assert w * d <= 10.0 * (1 + 1e-3)
    assert abs(vol - vol_ref) / vol_ref < 1e-3
    return vol


if __name__ == "__main__":
    main()
