"""2-D trajectory planning as a QCQP (port of
``examples/trajplan_qcqp.py``, after ref examples/trajplan_qcqp/src/
main.rs:17-146): t_cap time steps, variables the stacked x/y positions
(n = 2 t_cap); minimize total squared velocity (P0 = D1'D1 finite
differences), subject to per-step acceleration magnitude ||a(t)||^2 <=
A^2 (P_i = D2'D2, r_i = -A^2/2) and 12 equality constraints pinning
start/end positions and velocities and two waypoints. ``trajsweep_batch``
sweeps its builder over caps.

    python examples_torch/trajplan_qcqp.py [a_cap] [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import host, param, report, setup, tensors


def build(t_cap=30, a_cap=90.0):
    """(P0..Pm, q, r, A, b, t_cap, a_cap) as numpy arrays."""
    n = 2 * t_cap
    dt = 1.0 / t_cap

    # first-difference (velocity) operator on each coordinate
    d1 = np.zeros((n, n))
    for i in range(t_cap - 1):
        for off in (0, t_cap):
            d1[off + i, off + i] = -1.0 / dt
            d1[off + i, off + i + 1] = 1.0 / dt
    p_mats = [d1.T @ d1]
    q_vecs = [np.zeros(n)]
    r_scls = [0.0]

    dtdt = dt * dt
    for i in range(t_cap - 2):
        d2 = np.zeros((n, n))
        for off in (0, t_cap):
            d2[off + i, off + i] = 1.0 / dtdt
            d2[off + i, off + i + 1] = -2.0 / dtdt
            d2[off + i, off + i + 2] = 1.0 / dtdt
        p_mats.append(d2.T @ d2)
        q_vecs.append(np.zeros(n))
        r_scls.append(-0.5 * a_cap * a_cap)

    x_s, x_m1, x_m2, x_t = (0.0, 0.0), (0.5, -1.5), (0.25, 1.5), (1.0, 1.0)
    p = 12
    a = np.zeros((p, n))
    b = np.zeros(p)
    # x(0) = x_s, v(0) = 0 (both coords)
    a[0, 0] = 1.0
    b[0] = x_s[0]
    a[1, t_cap] = 1.0
    b[1] = x_s[1]
    a[2, 0], a[2, 1] = -1.0, 1.0
    a[3, t_cap], a[3, t_cap + 1] = -1.0, 1.0
    # x(1) = x_t, v(1) = 0
    a[4, t_cap - 1] = 1.0
    b[4] = x_t[0]
    a[5, 2 * t_cap - 1] = 1.0
    b[5] = x_t[1]
    a[6, t_cap - 2], a[6, t_cap - 1] = -1.0, 1.0
    a[7, 2 * t_cap - 2], a[7, 2 * t_cap - 1] = -1.0, 1.0
    # waypoints at t = 1/3 and 2/3
    t_m1, t_m2 = t_cap // 3, 2 * t_cap // 3
    a[8, t_m1] = 1.0
    b[8] = x_m1[0]
    a[9, t_cap + t_m1] = 1.0
    b[9] = x_m1[1]
    a[10, t_m2] = 1.0
    b[10] = x_m2[0]
    a[11, t_cap + t_m2] = 1.0
    b[11] = x_m2[1]

    return (np.stack(p_mats), np.stack(q_vecs), np.array(r_scls), a, b,
            t_cap, a_cap)


def main(t_cap=30, a_cap=90.0, cpu=None):
    device, dtype, backend = setup(cpu)
    import totsu_tpu_torch as tt

    p_mats, q_vecs, r_scls, a, b, t_cap, a_cap = build(t_cap, a_cap)
    prob = tt.problems.qcqp(*tensors(device, dtype, p_mats, q_vecs, r_scls,
                                     a, b))

    t0 = time.time()
    res = prob.solve_jit(param(dtype, max_iter=200_000, eps_acc=1e-3))
    n = 2 * t_cap
    sol = host(res.x)[:n]
    t_solve = time.time() - t0

    obj = float(0.5 * sol @ p_mats[0] @ sol)
    # self-checks: waypoint feasibility + acceleration bound
    viol_eq = float(np.abs(a @ sol - b).max())
    acc_max = 0.0
    for i in range(1, len(p_mats)):
        acc_max = max(acc_max, float(sol @ p_mats[i] @ sol))
    acc_max = np.sqrt(acc_max)
    report("trajplan_qcqp", res, t_solve,
           f"backend={backend} obj={obj:.4f} eq_viol={viol_eq:.2e} "
           f"max|a|={acc_max:.2f} (cap {a_cap})")
    assert viol_eq < 5e-3
    assert acc_max <= a_cap * 1.02
    return obj


if __name__ == "__main__":
    # a_cap overridable by first CLI argument (ref main.rs:29-34)
    cli_a_cap = 90.0
    if len(sys.argv) > 1 and not sys.argv[1].startswith("-"):
        cli_a_cap = float(sys.argv[1])
    main(a_cap=cli_a_cap)
