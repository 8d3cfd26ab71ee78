"""Max-cut-style graph partitioning as an SDP with randomized rounding
(port of ``examples/partitioning_sdp.py``).

After ref examples/partitioning_sdp/src/main.rs:21-163: a grid graph with
N(0, 1) edge weights W; solve  min Tr(W X) s.t. X >= 0 (PSD), X_ii = 1
(k = l = 48 nodes, p = l equalities); then Goemans-Williamson-style
rounding: sample Gaussian probes through X^(1/2) and take the best
sign-rounded cut (ref sample_feasible main.rs:80-135).

The SDP variable is the packed X (upper triangle, column-major): the
k-th variable multiplies the basis matrix -E_ij, and c is the raw packed
W (the reference's convention: off-diagonal weights counted once, the
same minimizer).

    python examples_torch/partitioning_sdp.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from examples_torch._common import host, param, report, setup, tensors


def pack_index(k):
    """Row and column of each packed entry, column-major upper triangle
    (``totsu_tpu_torch.ops.sympack``'s order)."""
    cc, rr = np.triu_indices(k)[::-1]
    order = np.lexsort((rr, cc))
    return rr[order], cc[order]


def packed_matrix(x, k):
    """The symmetric matrix of a plainly packed vector."""
    rr, cc = pack_index(k)
    m = np.zeros((k, k))
    m[rr, cc] = x
    m[cc, rr] = x
    return m


def grid_weights(x_num, y_num, rng):
    """A grid graph's N(0, 1) edge weights W."""
    l = x_num * y_num
    w = np.zeros((l, l))
    for i in range(l):
        x, y = divmod(i, y_num)
        if x < x_num - 1:
            w[i, i + y_num] = w[i + y_num, i] = rng.standard_normal()
        if y < y_num - 1:
            w[i, i + 1] = w[i + 1, i] = rng.standard_normal()
    return w


def build(x_num=8, y_num=6, seed=10_000):
    """The graph's weights W (l x l, l = x_num y_num)."""
    return grid_weights(x_num, y_num, np.random.default_rng(seed))


def sdp_data(w):
    """(c, F, A, b) for ``problems.sdp``: min c.x over the packed X with
    the LMI sum_k x_k (-E_k) <= 0 (X >= 0) and diag(X) = 1."""
    l = w.shape[0]
    sn = l * (l + 1) // 2
    rr, cc = pack_index(l)
    c = w[rr, cc]
    f_mats = np.zeros((sn + 1, l, l))
    f_mats[np.arange(sn), rr, cc] = -1.0
    f_mats[np.arange(sn), cc, rr] = -1.0
    a = np.zeros((l, sn))
    a[np.arange(l), np.nonzero(rr == cc)[0]] = 1.0
    return c, f_mats, a, np.ones(l)


def make_partitioning(x_num=8, y_num=6, seed=10_000):
    """(W, c, F, A, b): the graph and its SDP's data."""
    w = build(x_num, y_num, seed)
    return (w,) + sdp_data(w)


def sample_feasible(sol_packed, w, seed=20_000):
    """Random-hyperplane rounding through X^(1/2) (ref main.rs:80-135)."""
    l = w.shape[0]
    x_mat = packed_matrix(sol_packed, l)
    ew, ev = np.linalg.eigh(x_mat)
    root = (ev * np.sqrt(np.maximum(ew, 0.0))) @ ev.T
    rng = np.random.default_rng(seed)
    best_o, best_x = None, None
    for _ in range(l):
        probe = root @ rng.standard_normal(l)
        cut = np.where(probe > 0, 1.0, -1.0)
        o = float(cut @ w @ cut)
        if best_o is None or o < best_o:
            best_o, best_x = o, cut
    return best_o, best_x


def main(x_num=8, y_num=6, cpu=None):
    device, dtype, backend = setup(cpu)
    import totsu_tpu_torch as tt

    w, c, f_mats, a, b = make_partitioning(x_num, y_num)
    prob = tt.problems.sdp(*tensors(device, dtype, c, f_mats, a, b))
    t0 = time.time()
    res = prob.solve_jit(param(dtype, max_iter=200_000, eps_acc=1e-3))
    sol = host(res.x)
    t_solve = time.time() - t0

    o_feas, x_feas = sample_feasible(sol, w)
    # self-checks: SDP lower-bounds any feasible cut (weak duality);
    # rounding must beat a random cut on average
    l = w.shape[0]
    sdp_obj = float(np.trace(w @ packed_matrix(sol, l)))
    rng = np.random.default_rng(0)
    rand_cuts = [float(cut @ w @ cut) for cut in
                 np.where(rng.random((20, l)) > 0.5, 1.0, -1.0)]
    report("partitioning_sdp", res, t_solve,
           f"backend={backend} nodes={l} sdp_obj={sdp_obj:.4f} "
           f"best_cut={o_feas:.4f} rand_mean={np.mean(rand_cuts):.4f}")
    assert sdp_obj <= o_feas + 1e-2  # lower bound holds
    assert o_feas < np.mean(rand_cuts)  # rounding beats random
    return o_feas


if __name__ == "__main__":
    main()
