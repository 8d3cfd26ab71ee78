"""Truss compliance minimization (topology optimization) on a torus graph
as an SOCP (port of ``examples/toruscompl_socp.py``).

After ref examples/toruscompl_socp/src/main.rs:115-262: variables
(x, q, w) per member (cross-section, axial force, compliance epigraph);
l 2-row SOC blocks for q_i^2 v_i / e <= x_i w_i, 2l + 1 scalar SOC rows
for the bounds 0 <= x <= 1 and the volume budget, and the force-balance
equalities over the free degrees of freedom.

    python examples_torch/toruscompl_socp.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import host, param, report, setup, tensors


def build(x_num=9, y_num=7, vol_ratio=0.2):
    """(f, G_i, h_i, c_i, d_i, A, b, l, member lengths, vol_ratio) in
    numpy: the SOCP min f.v s.t. ||G_i v + h_i|| <= c_i.v + d_i, A v = b."""
    # nodes on a grid; "torus" connectivity pattern (ref make_torus)
    coords = [(x, y) for x in range(x_num) for y in range(y_num)]
    nodeidx = {c: i for i, c in enumerate(coords)}
    members = []  # (head, tail)
    for hx in range(x_num):
        for hy in range(y_num):
            if hx % 2 == 1 and hy % 2 == 0:
                dxdy = [(1, 0), (0, 1), (1, 1), (-1, 1), (1, -1), (-1, -1)]
            else:
                dxdy = [(1, 0), (0, 1)]
            for dx, dy in dxdy:
                t = (hx + dx, hy + dy)
                if t in nodeidx:
                    members.append((nodeidx[(hx, hy)], nodeidx[t]))

    # boundary conditions: x=0 column fixed; force (0,-1) at right-mid node
    fixed = {nodeidx[(0, y)] for y in range(y_num)}
    loads = {nodeidx[(x_num - 1, y_num // 2)]: (0.0, -1.0)}

    # dof indices
    dof_idx, dof = {}, 0
    for i in range(len(coords)):
        if i in fixed:
            dof_idx[i] = None
        else:
            dof_idx[i] = dof
            dof += 2

    l = len(members)
    n = 3 * l  # x, q, w
    e_mod = 1.0
    vlen = np.array([np.hypot(coords[h][0] - coords[t][0],
                              coords[h][1] - coords[t][1])
                     for h, t in members])

    f = np.zeros(n)
    f[2 * l:] = 1.0  # minimize sum of w

    g_list, h_list, c_list, d_list = [], [], [], []
    for i in range(l):
        gi = np.zeros((2, n))
        gi[0, i] = -1.0
        gi[0, 2 * l + i] = 1.0
        gi[1, l + i] = np.sqrt(2.0 * vlen[i] / e_mod)
        ci = np.zeros(n)
        ci[i] = 1.0
        ci[2 * l + i] = 1.0
        g_list.append(gi)
        h_list.append(np.zeros(2))
        c_list.append(ci)
        d_list.append(0.0)
    for sign, d in ((1.0, 0.0), (-1.0, 1.0)):  # 0 <= x_i, then x_i <= 1
        for i in range(l):
            ci = np.zeros(n)
            ci[i] = sign
            g_list.append(np.zeros((0, n)))
            h_list.append(np.zeros(0))
            c_list.append(ci)
            d_list.append(d)
    # volume budget: sum v_i x_i <= total_volume * vol_ratio
    ci = np.zeros(n)
    ci[:l] = -vlen
    g_list.append(np.zeros((0, n)))
    h_list.append(np.zeros(0))
    c_list.append(ci)
    d_list.append(float(vlen.sum() * vol_ratio))

    # force balance: A q = b over free dofs
    a = np.zeros((dof, n))
    b = np.zeros(dof)
    for i, (hidx, tidx) in enumerate(members):
        beta = np.array([coords[tidx][0] - coords[hidx][0],
                         coords[tidx][1] - coords[hidx][1]], dtype=float)
        beta /= np.linalg.norm(beta)
        if dof_idx[hidx] is not None:
            a[dof_idx[hidx], l + i] += -beta[0]
            a[dof_idx[hidx] + 1, l + i] += -beta[1]
        if dof_idx[tidx] is not None:
            a[dof_idx[tidx], l + i] += beta[0]
            a[dof_idx[tidx] + 1, l + i] += beta[1]
    for node, (px, py) in loads.items():
        if dof_idx[node] is not None:
            b[dof_idx[node]] = px
            b[dof_idx[node] + 1] = py

    return f, g_list, h_list, c_list, d_list, a, b, l, vlen, vol_ratio


def main(x_num=9, y_num=7, cpu=None):
    device, dtype, backend = setup(cpu)
    import totsu_tpu_torch as tt

    (f, g_list, h_list, c_list, d_list, a, b, l, vlen,
     vol_ratio) = build(x_num, y_num)
    prob = tt.problems.socp(*tensors(device, dtype, f, g_list, h_list,
                                     c_list, d_list, a, b))

    t0 = time.time()
    res = prob.solve_jit(param(dtype, max_iter=200_000, eps_acc=1e-3))
    sol = host(res.x)
    t_solve = time.time() - t0

    x_sec, w_comp = sol[:l], sol[2 * l:3 * l]
    obj = float(w_comp.sum())
    # self-checks: bounds, volume budget, force balance
    vol = float(vlen @ x_sec)
    budget = float(vlen.sum() * vol_ratio)
    eq_viol = float(np.abs(a @ sol - b).max())
    report("toruscompl_socp", res, t_solve,
           f"backend={backend} members={l} obj={obj:.4f} "
           f"vol={vol:.3f}<={budget:.3f} eq_viol={eq_viol:.2e}")
    assert x_sec.min() > -5e-3 and x_sec.max() < 1.005
    assert vol <= budget * 1.01
    assert eq_viol < 5e-3
    return obj


if __name__ == "__main__":
    main()
