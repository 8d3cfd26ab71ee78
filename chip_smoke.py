"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels of the port from ``totsu_tpu_torch/csrc``
(nvcc, sm_90a, all at once), holds each against its plain PyTorch version
on the card, drives the solver's main paths at full width (the n=1000
benchmark LP, A 4000 x 1000 f32, and the exp-cone logistic regression,
A 7040 x 3040 f32, on the host loop; the n=100 LP, a QP, a GP, a
pow/exp growth portfolio and the n=1000 LP on the megakernel, each with
its launch plan), and checks the answers against HiGHS, L-BFGS-B and
SLSQP; then the direct engine (the golden LP through method='direct'
in f64; the n=1000 and n=4000 LPs, the logistic regression, the GP and
the growth portfolio under profile='fast'), the fast profile's
megakernel branch against the direct engine, and accel='restart' on the
host loop; resume, chunking and logging (phases 17-19); the structured
operators and the indirect engine (phases 20-22); kernel J, the Jacobi
PSD projection, against its plain version (phase 23), and the SDP, SOCP
and QCQP builders and the custom cone (phases 24-26: the partitioning
SDP dense and structured with each PSD method, the nearest-correlation
batch, the trajectory QCQP, the torus SOCP), whose f64 references run on
the CPU in a child process (``--cpu-references``, used by the script
itself). Each phase prints one line of its own
numbers; any failed check raises, so the script exits non-zero and prints
no final line. It needs a CUDA device and the repository beside it; it imports
nothing of JAX.

The last two lines of standard output are the kernels' JSON record and
the JSON status line ``{"ok": true, "device": {...}}``.
"""

import atexit
import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Every solver-path product in full f32: no TF32 anywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok, msg):
    if not ok:
        fail(msg)


def sync_time(fn, reps):
    """Median wall seconds of ``fn()`` over ``reps`` runs, each ended by a
    device synchronize; returns (median, last result)."""
    times = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def loop_ms(fn, calls=200, warmup=10):
    """Milliseconds per call of ``fn()``: CUDA events around ``calls``
    back-to-back calls, elapsed time over the count."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, calls=20, windows=5):
    """Device milliseconds per call of ``fn()``: the kernel time the
    profiler attributes to the calls (host time between kernels
    excluded), the median over ``windows`` profiled windows of ``calls``
    calls. A window can lose kernel records (it then reads a third to all
    of the time too low on identical work), so each kernel counts at its
    mean time per record times its records per call, rounded up; None
    when no window reports device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # kernel rows only: an operator's own row repeats its kernels' time
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.count > 0 and e.self_device_time_total > 0]
        if rows:
            per_call.append(sum(e.self_device_time_total / e.count
                                * -(-e.count // calls) for e in rows) / 1e3)
    return statistics.median(per_call) if per_call else None


def stream_ms(fn, calls=50):
    """Device milliseconds per call of ``fn()`` back to back, by CUDA
    events: the calls are queued behind a kernel that sleeps until the
    host has queued them all, so host time stays out and the gaps between
    the calls' kernels count. None if the host could not get ahead."""
    fn()
    torch.cuda.synchronize()
    for cycles in (4_000_000, 16_000_000, 64_000_000):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        late = start.query()  # the sleep ended before the host was done
        end.synchronize()
        if not late:
            return start.elapsed_time(end) / calls
    return None


def make_lp(n, seed=0):
    """bench.make_lp: random inequalities G x <= h (m = 2n) plus the box
    |x| <= 10, f32."""
    rng = np.random.default_rng(seed)
    m = 2 * n
    g = rng.normal(size=(m, n))
    x0 = rng.normal(size=n)
    h = g @ x0 + rng.random(m) + 0.1
    eye = np.eye(n)
    g = np.concatenate([g, eye, -eye], axis=0).astype(np.float32)
    h = np.concatenate([h, np.full(n, 10.0), np.full(n, 10.0)]).astype(
        np.float32)
    c = rng.normal(size=n).astype(np.float32)
    return c, g, h


def make_qp(n, seed=0):
    """bench.make_qp: diagonal-P QP, G = -uniform (m = n), f32."""
    rng = np.random.default_rng(seed)
    p_diag = rng.random(n).astype(np.float32) + 0.01
    q = rng.random(n).astype(np.float32)
    g = -rng.random((n, n)).astype(np.float32)
    h = -rng.random(n).astype(np.float32)
    return np.diag(p_diag), q, g, h


def make_tiles_lp(n=65_536, bm=128, seed=11):
    """bench.py's n = 65,536 from-tiles LP (the ``grp_ell`` row
    ``ell_n65536_tiles_*``) at any n divisible by bm: a block-tridiagonal
    band of (bm, bm) tiles, each N(0, 1) / sqrt(3 bm), a feasible point
    x_feas; the LP [band; I; -I] x <= (band x_feas + U(0, 1) + 0.1, 10,
    10), f32. Returns (tiles, b, c), the tiles as a dict (tile_row,
    tile_col) -> array; nothing dense is ever built."""
    rng = np.random.default_rng(seed)
    nb = n // bm
    tiles = {}
    x_feas = rng.normal(size=n).astype(np.float32)
    ax = np.zeros(n, np.float32)
    for i in range(nb):
        for j in (i - 1, i, i + 1):
            if 0 <= j < nb:
                t = (rng.normal(size=(bm, bm)) / np.sqrt(3 * bm)
                     ).astype(np.float32)
                tiles[(i, j)] = t
                ax[i * bm:(i + 1) * bm] += t @ x_feas[j * bm:(j + 1) * bm]
    b = np.concatenate([ax + rng.random(n).astype(np.float32) + 0.1,
                        np.full(n, 10.0, np.float32),
                        np.full(n, 10.0, np.float32)])
    c = rng.normal(size=n).astype(np.float32)
    return tiles, b, c


def tiles_box_csr(tiles, n, bm):
    """[band; I; -I] of ``make_tiles_lp`` as a scipy CSR matrix, built
    from the tiles (never dense): the host's copy for the f64 residuals."""
    from scipy import sparse
    keys = sorted(tiles)
    indptr = np.searchsorted([i for i, _ in keys], np.arange(n // bm + 1))
    band = sparse.bsr_matrix(
        (np.stack([tiles[k] for k in keys]),
         np.array([j for _, j in keys]), indptr), shape=(n, n))
    eye = sparse.identity(n, dtype=np.float32, format="csr")
    return sparse.vstack([band.tocsr(), eye, -eye]).tocsr()


def make_banded_box_lp(n, k_tiles=2, tile=128, seed=0):
    """benchmarks/benchmark_indirect.py's make_banded_box_lp: feasible and
    bounded banded LP [band; I; -I] x <= [b; 10; 10], f32."""
    rng = np.random.default_rng(seed)
    nb = n // tile
    a = np.zeros((3 * n, n), dtype=np.float32)
    for i in range(nb):
        for d in range(k_tiles):
            j = (i + d) % nb
            a[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = \
                rng.normal(size=(tile, tile)).astype(np.float32) / np.sqrt(
                    k_tiles * tile)
    a[n:2 * n] = np.eye(n, dtype=np.float32)
    a[2 * n:] = -np.eye(n, dtype=np.float32)
    x0 = rng.normal(size=n)
    b = np.concatenate([
        (a[:n] @ x0 + rng.random(n) + 0.1),
        np.full(n, 10.0), np.full(n, 10.0)]).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    return c, a, b


def make_banded_lp(n, k_tiles, tile=128, seed=0):
    """benchmarks/benchmark_sparse.py's make_banded_lp: block-banded
    feasible LP, k_tiles (tile, tile) tiles per tile-row along the
    diagonal band (wrap-around), dense inside tiles, f32."""
    rng = np.random.default_rng(seed)
    nb = n // tile
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(nb):
        for d in range(k_tiles):
            j = (i + d) % nb
            a[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = \
                rng.normal(size=(tile, tile)).astype(np.float32) / np.sqrt(
                    k_tiles * tile)
    x0 = rng.normal(size=n)
    b = (a @ x0 + rng.random(n) + 0.1).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    return c, a, b


def make_stencil_op(tt, n, device, adjoint=True):
    """benchmarks/benchmark_indirect.py's make_stencil_op in torch: a
    circulant 3-point stencil plus box rows as one CustomOp (m = 3n), f32,
    with hand-derived absolute sums; ``adjoint=False`` leaves the adjoint
    to autograd."""
    w = torch.tensor([1.0, -0.45, -0.55], dtype=torch.float32,
                     device=device)

    def mv(params, x):
        s = params[0] * x + params[1] * torch.roll(x, 1) \
            + params[2] * torch.roll(x, -1)
        return torch.cat([s, x, -x])

    def rmv(params, y):
        n_ = y.shape[0] // 3
        ys, yp, ym = y[:n_], y[n_:2 * n_], y[2 * n_:]
        return (params[0] * ys + params[1] * torch.roll(ys, -1)
                + params[2] * torch.roll(ys, 1)) + yp - ym

    absw = float(np.abs(np.array([1.0, -0.45, -0.55], np.float32)).sum())

    def col_abssum(params):
        return torch.full((n,), absw + 2.0, dtype=torch.float32,
                          device=device)

    def row_abssum(params):
        return torch.cat([torch.full((n,), absw, dtype=torch.float32,
                                     device=device),
                          torch.ones(2 * n, dtype=torch.float32,
                                     device=device)])

    return tt.CustomOp(params=w, m=3 * n, n=n, matvec_fn=mv,
                       rmatvec_fn=rmv if adjoint else None,
                       col_abssum_fn=col_abssum, row_abssum_fn=row_abssum)


def make_stencil_lp(tt, n, device, seed=1, adjoint=True):
    """benchmarks/benchmark_indirect.py's make_stencil_lp in torch:
    (c, op, b), f32 on ``device``."""
    rng = np.random.default_rng(seed)
    op = make_stencil_op(tt, n, device, adjoint=adjoint)
    x0 = torch.tensor(rng.normal(size=n), dtype=torch.float32, device=device)
    bs = op.matvec(x0)[:n] + torch.tensor(rng.random(n) + 0.1,
                                          dtype=torch.float32, device=device)
    b = torch.cat([bs, torch.full((2 * n,), 10.0, dtype=torch.float32,
                                  device=device)])
    c = torch.tensor(rng.normal(size=n), dtype=torch.float32, device=device)
    return c, op, b


def make_logreg(m, n, lam=0.1, seed=3):
    """examples/logreg_expcone.py: its data generator and ``build``, in
    numpy. L1-regularised logistic regression over m samples and n
    features; variables z = [w (n) | t (m) | u (m) | v (m) | a (n)], each
    softplus epigraph two exp blocks (z_i - t_i, 1, u_i), (-t_i, 1, v_i)
    and a budget row u_i + v_i <= 1, |w_j| <= a_j as two R+ rows.
    Returns (x, y, c, A, b, cone spec)."""
    rng = np.random.default_rng(seed)
    w_true = np.concatenate([rng.normal(size=n // 2) * 2.0,
                             np.zeros(n - n // 2)])
    x = rng.normal(size=(m, n))
    y = np.where(x @ w_true + 0.3 * rng.normal(size=m) > 0, 1.0, -1.0)
    nv = 2 * n + 3 * m
    it, iu, iv = n + np.arange(m), n + m + np.arange(m), n + 2 * m + np.arange(m)
    iw, ia = np.arange(n), n + 3 * m + np.arange(n)
    a = np.zeros((m + 2 * n + 6 * m, nv))
    b = np.zeros(m + 2 * n + 6 * m)
    rows = np.arange(m)
    a[rows, iu] = 1.0                         # 1 - u_i - v_i >= 0
    a[rows, iv] = 1.0
    b[:m] = 1.0
    rj = m + 2 * np.arange(n)
    a[rj, ia], a[rj, iw] = -1.0, 1.0          # a_j - w_j >= 0
    a[rj + 1, ia], a[rj + 1, iw] = -1.0, -1.0  # a_j + w_j >= 0
    e0 = m + 2 * n + 3 * rows                 # (z_i - t_i, 1, u_i)
    a[e0, :n] = y[:, None] * x
    a[e0, it] = 1.0
    b[e0 + 1] = 1.0
    a[e0 + 2, iu] = -1.0
    e1 = m + 2 * n + 3 * m + 3 * rows         # (-t_i, 1, v_i)
    a[e1, it] = 1.0
    b[e1 + 1] = 1.0
    a[e1 + 2, iv] = -1.0
    c = np.zeros(nv)
    c[n:n + m] = 1.0
    c[n + 3 * m:] = lam
    return x, y, c, a, b, [("rpos", (m + 2 * n,)), ("expc", (2 * m,))]


def logreg_objective(x, y, w, lam):
    return float(np.sum(np.logaddexp(0.0, -y * (x @ w)))
                 + lam * np.abs(w).sum())


def logreg_reference(x, y, lam):
    """The L1-regularised logistic loss minimised by scipy's L-BFGS-B on
    the split smooth form w = p - q, p, q >= 0; returns the objective."""
    from scipy.optimize import minimize
    n = x.shape[1]

    def f(z):
        w = z[:n] - z[n:]
        mrg = -y * (x @ w)
        g = x.T @ (-y / (1.0 + np.exp(-mrg)))   # d/dw of sum softplus
        return (float(np.sum(np.logaddexp(0.0, mrg)) + lam * z.sum()),
                np.concatenate([g + lam, -g + lam]))

    r = minimize(f, np.zeros(2 * n), jac=True, method="L-BFGS-B",
                 bounds=[(0.0, None)] * (2 * n),
                 options={"maxiter": 20_000, "ftol": 1e-15, "gtol": 1e-10})
    return logreg_objective(x, y, r.x[:n] - r.x[n:], lam)


def make_gp_terms(n=100, n_con=100, k=4, seed=0):
    """A random feasible, bounded GP: minimise sum_j 1/x_j subject to
    n_con posynomials of k monomials (each over 3 random variables with
    exponents in [0.2, 1]) scaled so f_i(1) = 0.5, and the box monomials
    x_j / 10 <= 1. Returns (term_c, term_a) for ``problems.gp``."""
    rng = np.random.default_rng(seed)
    term_c, term_a = [np.ones(n)], [-np.eye(n)]
    for _ in range(n_con):
        ex = np.zeros((k, n))
        for r in range(k):
            ex[r, rng.choice(n, size=3, replace=False)] = rng.uniform(
                0.2, 1.0, size=3)
        coef = rng.uniform(0.5, 1.5, size=k)
        term_c.append(coef * 0.5 / coef.sum())
        term_a.append(ex)
    for j in range(n):
        term_c.append(np.array([0.1]))
        term_a.append(np.eye(n)[j:j + 1])
    return term_c, term_a


def gp_reference(term_c, term_a):
    """The GP's optimal value by scipy SLSQP on the log-form NLP: minimise
    lse_0(A_0 y + log c_0) subject to lse_i(A_i y + log c_i) <= 0."""
    from scipy.optimize import minimize
    from scipy.special import logsumexp, softmax
    lc = [np.log(ci) for ci in term_c]

    def lse(i, yv):
        return logsumexp(term_a[i] @ yv + lc[i])

    def lse_grad(i, yv):
        return softmax(term_a[i] @ yv + lc[i]) @ term_a[i]

    cons = range(1, len(term_c))
    r = minimize(lambda yv: lse(0, yv), np.zeros(term_a[0].shape[1]),
                 jac=lambda yv: lse_grad(0, yv), method="SLSQP",
                 constraints=[{
                     "type": "ineq",
                     "fun": lambda yv: -np.array([lse(i, yv) for i in cons]),
                     "jac": lambda yv: -np.stack([lse_grad(i, yv)
                                                  for i in cons])}],
                 options={"maxiter": 1000, "ftol": 1e-12})
    if not r.success:
        fail(f"SLSQP on the GP: {r.message}")
    return float(np.exp(r.fun))


def make_growth(s_num=64, n=50, h_budget=-2.0, seed=0):
    """examples/growthport_powexp.py: its data generator and
    ``build_problem``, in numpy. Growth-optimal allocation over s_num
    scenarios and n assets: the geometric mean as a binary tree of
    pow(1/2) blocks, the entropy budget sum x log x <= H as n exp blocks.
    Returns (returns, c, A, b, cone spec, index of the tree root)."""
    rng = np.random.default_rng(seed)
    returns = 1.0 + 0.3 * rng.standard_normal((s_num, n)) ** 2 \
        - 0.1 * rng.random((s_num, n))
    nv = 2 * n + s_num - 1    # x (n) | q (n) | tree nodes, root last
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
    c[2 * n + k - 1] = -1.0   # maximise the root = the geometric mean
    spec = [("zero", (1,)), ("rpos", (n + 1,)), ("powc", (0.5, k)),
            ("expc", (n,))]
    return returns, c, np.asarray(rows), np.asarray(bs), spec, 2 * n + k - 1


def growth_reference(returns, h_budget):
    """examples/growthport_powexp.py's oracle: SLSQP on the log-form NLP;
    returns the optimal geometric mean."""
    from scipy.optimize import minimize
    n = returns.shape[1]
    cons = [
        {"type": "eq", "fun": lambda x: x.sum() - 1.0},
        {"type": "ineq",
         "fun": lambda x: h_budget - np.sum(x * np.log(np.maximum(x, 1e-12)))},
    ]
    r = minimize(lambda x: -np.mean(np.log(returns @ x)), np.full(n, 1.0 / n),
                 method="SLSQP", bounds=[(0.0, 1.0)] * n, constraints=cons,
                 options={"maxiter": 500, "ftol": 1e-12})
    return float(np.exp(-r.fun))


def pack_index(k):
    """Row and column of each packed entry, column-major upper triangle
    (``ops/sympack.py`` ``_pack_index``)."""
    cc, rr = np.triu_indices(k)[::-1]
    order = np.lexsort((rr, cc))
    return rr[order], cc[order]


def packed_matrix(x, k):
    """The symmetric matrix of a plainly packed vector (the partitioning
    example's ``_unpack``)."""
    rr, cc = pack_index(k)
    m = np.zeros((k, k))
    m[rr, cc] = x
    m[cc, rr] = x
    return m


def grid_weights(x_num, y_num, rng):
    """A grid graph's N(0, 1) edge weights W (examples/partitioning_sdp.py
    build, :21-32; benchmarks/benchmark_sdp.py build_partitioning,
    :76-84)."""
    l = x_num * y_num
    w = np.zeros((l, l))
    for i in range(l):
        x, y = divmod(i, y_num)
        if x < x_num - 1:
            w[i, i + y_num] = w[i + y_num, i] = rng.standard_normal()
        if y < y_num - 1:
            w[i, i + 1] = w[i + 1, i] = rng.standard_normal()
    return w


def make_partitioning(x_num=8, y_num=6, seed=10_000):
    """The reference's partitioning SDP as ``problems.sdp`` data
    (examples/partitioning_sdp.py build :21-32 and solve_sdp :35-65): min
    <W, X> over the packed X, F_kk = -E_ij for each packed slot (X >= 0),
    diag(X) = 1. Returns (w, c, f_mats, a, b)."""
    w = grid_weights(x_num, y_num, np.random.default_rng(seed))
    l = w.shape[0]
    sn = l * (l + 1) // 2
    rr, cc = pack_index(l)
    c = w[rr, cc]
    f_mats = np.zeros((sn + 1, l, l))
    f_mats[np.arange(sn), rr, cc] = -1.0
    f_mats[np.arange(sn), cc, rr] = -1.0
    a = np.zeros((l, sn))
    a[np.arange(l), np.nonzero(rr == cc)[0]] = 1.0
    return w, c, f_mats, a, np.ones(l)


def make_partitioning_structured(l, seed=10_000):
    """benchmarks/benchmark_sdp.py build_partitioning (:66-96) in numpy:
    c the raw packed W, A' = [diag(-dscale); the selection of diag(X)]
    (dscale 1 on diagonal slots, sqrt2 off), b' = [0; 1], all f32.
    Returns (w, c, neg_dscale, sel, b)."""
    rng = np.random.default_rng(seed)
    y_num = int(np.sqrt(l))
    while l % y_num:
        y_num -= 1
    w = grid_weights(l // y_num, y_num, rng)
    sn = l * (l + 1) // 2
    rr, cc = pack_index(l)
    dscale = np.where(rr == cc, 1.0, np.sqrt(2.0)).astype(np.float32)
    sel = np.zeros((l, sn), np.float32)
    sel[np.arange(l), np.nonzero(rr == cc)[0]] = 1.0
    b = np.concatenate([np.zeros(sn, np.float32), np.ones(l, np.float32)])
    return w, w[rr, cc].astype(np.float32), -dscale, sel, b


def make_noisy_covs(batch, k, seed=5):
    """examples/nearestcorr_batch_sdp.py make_noisy_covs (:39-50): noisy
    correlation estimates, possibly indefinite."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        f = rng.normal(size=(k, 3)) / np.sqrt(3)
        s = f @ f.T + 0.3 * np.diag(rng.random(k))
        d = 1.0 / np.sqrt(np.diag(s))
        corr = d[:, None] * s * d[None, :]
        e = rng.normal(size=(k, k)) * 0.15
        out.append(corr + (e + e.T) / 2)
    return np.stack(out)


def nearestcorr_data(k):
    """examples/nearestcorr_batch_sdp.py build (:53-84) without its
    layout: over u = (packed scaled X, t), min t subject to (t, x -
    vec(S)) in SOC, x in vec(PSD_k), diag(X) = 1. Returns (a, c, sn); the
    layout is SOC(1 + sn), PSD(k), zero(k)."""
    sn = k * (k + 1) // 2
    a = np.zeros((1 + 2 * sn + k, sn + 1))
    a[0, sn] = -1.0
    a[1:1 + sn, :sn] = -np.eye(sn)
    a[1 + sn:1 + 2 * sn, :sn] = -np.eye(sn)
    diag_pos = np.array([j * (j + 1) // 2 + j for j in range(k)])
    a[1 + 2 * sn + np.arange(k), diag_pos] = 1.0
    c = np.zeros(sn + 1)
    c[sn] = 1.0
    return a, c, sn


def nearestcorr_b(s_mat):
    """b of one instance (the example's solve_one, :101-105): [0; -vec(S)
    scaled; 0; 1]."""
    k = s_mat.shape[0]
    rr, cc = pack_index(k)
    vec_s = s_mat[rr, cc] * np.where(rr == cc, 1.0, np.sqrt(2.0))
    return np.concatenate([[0.0], -vec_s, np.zeros(len(rr)), np.ones(k)])


def make_trajplan(t_cap=30, a_cap=90.0):
    """examples/trajplan_qcqp.py build (:22-83): P0..Pm, q, r, A, b of the
    2-D trajectory QCQP (minimum squared velocity, |acceleration| <=
    a_cap, pinned ends and two waypoints)."""
    n = 2 * t_cap
    dt = 1.0 / t_cap
    d1 = np.zeros((n, n))
    for i in range(t_cap - 1):
        for off in (0, t_cap):
            d1[off + i, off + i] = -1.0 / dt
            d1[off + i, off + i + 1] = 1.0 / dt
    p_mats, q_vecs, r_scls = [d1.T @ d1], [np.zeros(n)], [0.0]
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
    a = np.zeros((12, n))
    b = np.zeros(12)
    a[0, 0], b[0] = 1.0, x_s[0]
    a[1, t_cap], b[1] = 1.0, x_s[1]
    a[2, 0], a[2, 1] = -1.0, 1.0
    a[3, t_cap], a[3, t_cap + 1] = -1.0, 1.0
    a[4, t_cap - 1], b[4] = 1.0, x_t[0]
    a[5, 2 * t_cap - 1], b[5] = 1.0, x_t[1]
    a[6, t_cap - 2], a[6, t_cap - 1] = -1.0, 1.0
    a[7, 2 * t_cap - 2], a[7, 2 * t_cap - 1] = -1.0, 1.0
    t_m1, t_m2 = t_cap // 3, 2 * t_cap // 3
    a[8, t_m1], b[8] = 1.0, x_m1[0]
    a[9, t_cap + t_m1], b[9] = 1.0, x_m1[1]
    a[10, t_m2], b[10] = 1.0, x_m2[0]
    a[11, t_cap + t_m2], b[11] = 1.0, x_m2[1]
    return np.stack(p_mats), np.stack(q_vecs), np.array(r_scls), a, b


def make_torus(x_num=9, y_num=7, vol_ratio=0.2):
    """examples/toruscompl_socp.py build (:19-127): the truss compliance
    SOCP on a torus grid. Returns (f, g_list, h_list, c_list, d_list, a,
    b, l, vlen)."""
    coords = [(x, y) for x in range(x_num) for y in range(y_num)]
    nodeidx = {c: i for i, c in enumerate(coords)}
    members = []
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
    fixed = {nodeidx[(0, y)] for y in range(y_num)}
    loads = {nodeidx[(x_num - 1, y_num // 2)]: (0.0, -1.0)}
    dof_idx, dof = {}, 0
    for i in range(len(coords)):
        if i in fixed:
            dof_idx[i] = None
        else:
            dof_idx[i] = dof
            dof += 2
    l = len(members)
    n = 3 * l
    vlen = np.array([np.hypot(coords[h][0] - coords[t][0],
                              coords[h][1] - coords[t][1])
                     for h, t in members])
    f = np.zeros(n)
    f[2 * l:] = 1.0
    g_list, h_list, c_list, d_list = [], [], [], []
    for i in range(l):
        gi = np.zeros((2, n))
        gi[0, i] = -1.0
        gi[0, 2 * l + i] = 1.0
        gi[1, l + i] = np.sqrt(2.0 * vlen[i])
        ci = np.zeros(n)
        ci[i] = ci[2 * l + i] = 1.0
        g_list.append(gi)
        h_list.append(np.zeros(2))
        c_list.append(ci)
        d_list.append(0.0)
    for sign, d in ((1.0, 0.0), (-1.0, 1.0)):  # 0 <= x_i, x_i <= 1
        for i in range(l):
            ci = np.zeros(n)
            ci[i] = sign
            g_list.append(np.zeros((0, n)))
            h_list.append(np.zeros(0))
            c_list.append(ci)
            d_list.append(d)
    ci = np.zeros(n)
    ci[:l] = -vlen
    g_list.append(np.zeros((0, n)))
    h_list.append(np.zeros(0))
    c_list.append(ci)
    d_list.append(float(vlen.sum() * vol_ratio))
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
    return f, g_list, h_list, c_list, d_list, a, b, l, vlen


def cone(tt, spec):
    """A ConeLayout of the port from a (factor name, args) spec."""
    return tt.ConeLayout([getattr(tt, kind)(*args) for kind, args in spec])


def print_ptxas(name, lib_path):
    """The registers and spills ptxas reported for each kernel of a
    library (from the build log; 'cached' when it was not built here)."""
    log = lib_path.with_suffix(".log")
    if not log.exists():
        print(f"  ptxas {name}: cached library, no build log", flush=True)
        return
    entry = func = None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "Function properties for" in line:
            func = line.rsplit(" ", 1)[-1]
        elif "spill stores" in line:
            print(f"  ptxas {name} {func}: {line.strip()}", flush=True)
        elif "Used" in line and "registers" in line:
            print(f"  ptxas {name} {entry}: {line.split(':', 1)[-1].strip()}",
                  flush=True)


def cone_blocks(kind, count, rng, alpha=0.5):
    """(count, 3) f64 test blocks for the exp or pow cone: a fifth each of
    random normal blocks, points in the cone, in the polar, in the
    negative quadrant and on the boundary, each block scaled by 10^U(-6,
    6)."""
    q = count // 5
    u = rng.random((q, 1)) + 0.01
    normal = rng.normal(size=(count - 4 * q, 3))
    if kind == "exp":
        s = rng.random(q) + 0.1
        r = rng.normal(size=q)
        inside = np.stack([r, s, s * np.exp(r / s) * (1.0 + u[:, 0])], 1)
        rp = rng.random(q) + 0.1
        sp = rng.normal(size=q)
        polar = np.stack([rp, sp, -rp * np.exp(sp / rp) / np.e
                          * (1.0 + u[:, 0])], 1)
        negq = np.stack([-rng.random(q), -rng.random(q),
                         rng.normal(size=q)], 1)
        bound = np.stack([r, s, s * np.exp(r / s)], 1)
    else:
        xy = rng.random((q, 2)) + 0.05
        pv = xy[:, 0] ** alpha * xy[:, 1] ** (1.0 - alpha)
        sign = np.where(rng.random(q) < 0.5, -1.0, 1.0)
        inside = np.stack([xy[:, 0], xy[:, 1], sign * pv * u[:, 0] / 1.02],
                          1)
        dxy = rng.random((q, 2)) + 0.05
        dv = (dxy[:, 0] / alpha) ** alpha \
            * (dxy[:, 1] / (1.0 - alpha)) ** (1.0 - alpha)
        polar = np.stack([-dxy[:, 0], -dxy[:, 1], sign * dv * u[:, 0] / 1.02],
                         1)
        negq = np.stack([-rng.random(q), -rng.random(q),
                         sign * (5.0 + rng.random(q))], 1)
        bound = np.stack([xy[:, 0], xy[:, 1], sign * pv], 1)
    blocks = np.concatenate([normal, inside, polar, negq, bound])
    return blocks * 10.0 ** rng.uniform(-6, 6, size=(count, 1))


# operation counts of cone_exppow.cuh, counted from its source (adds,
# multiplies, divides, compares and transcendental calls each 1): per
# block outside the loops, per exp expansion trip (one evaluation of h),
# per exp Newton-bisection trip (h and h'), per pow trip
OPS_EXP_BLOCK, OPS_EXP_EXPAND, OPS_EXP_HYBRID = 35, 22, 42
OPS_POW_BLOCK, OPS_POW_TRIP = 60, 58


def cone_proj_trips(blocks, kind, alpha, dual):
    """The trips of the plain version's root finders on these blocks, each
    block running until its state stops changing (the exit of a serial
    root finder): the total of each loop (exp: the bracket expansion,
    then the Newton-bisection; pow: one loop) and the longest chain, the
    most trips one block takes over its loops."""
    from totsu_tpu_torch.ops.kernels import cone_proj as cp
    from totsu_tpu_torch.solver import cone as cones
    per_block = []

    def counting(step, state, trips):
        done = torch.zeros(state[0].shape, dtype=torch.bool,
                           device=state[0].device)
        taken = torch.zeros(state[0].shape, dtype=torch.long,
                            device=state[0].device)
        for _ in range(trips):
            nxt = step(state)
            same = torch.stack([(a == b) | (a.isnan() & b.isnan())
                                for a, b in zip(nxt, state)]).all(0)
            taken += ~done
            done |= same
            if bool(done.all()):
                break
            state = nxt
        per_block.append(taken)
        return state

    real = cones._fixed_trips
    cones._fixed_trips = counting
    try:
        cp.cone_proj_plain(blocks, kind, alpha, dual)
    finally:
        cones._fixed_trips = real
    # the loops of one call run on the same blocks in the same order
    chain = int(sum(per_block).max()) if per_block else 0
    return [int(t.sum()) for t in per_block], chain


def cone_proj_ops(blocks, kind, alpha, dual):
    """Operations the blocked projection does on these blocks: every
    block's tests, plus the trips of the root finders that each block
    runs until its state stops changing (the serial root finder's exit;
    ``cone_proj_trips``). The count follows the reference's trips, not
    the kernel's lane-parallel rounds, so the bound does not move with the
    implementation."""
    totals = cone_proj_trips(blocks, kind, alpha, dual)[0]
    count = blocks.shape[0]
    if kind == "exp":
        expand, hybrid = totals if totals else (0, 0)
        return (count * OPS_EXP_BLOCK + expand * OPS_EXP_EXPAND
                + hybrid * OPS_EXP_HYBRID)
    return count * OPS_POW_BLOCK + sum(totals) * OPS_POW_TRIP


# the card's published peaks (NVIDIA H100 SXM data sheet, at its 700 W
# power limit): HBM3 bandwidth, and f32 / f64 rates outside the tensor
# cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}


def bound_ms(nbytes, ops, dtype=torch.float32):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate; and which."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fmt_ms(x):
    return "n/a" if x is None else f"{x:.4f}"


def cone_eval_latency(cp, dev, evals=20_000):
    """Per (kind, str(dtype)): clocks and device ms of one evaluation of
    the exp root function with its derivative or of the pow one, from a
    chain of ``evals`` dependent evaluations in one thread
    (``cp.eval_clocks``): clocks by ``clock64``, ms by CUDA events around
    the launch."""
    out = {}
    for kind in ("exp", "pow"):
        for dt in (torch.float32, torch.float64):
            cp.eval_clocks(kind, dt, 10, dev)  # build, load, warm up
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            clocks = cp.eval_clocks(kind, dt, evals, dev)
            end.record()
            end.synchronize()
            out[(kind, str(dt))] = (clocks / evals,
                                    start.elapsed_time(end) / evals)
    return out


def cone_proj_floor(cp, blocks, kind, alpha, dual, latency):
    """(the kernel's longest chain by its torch model, the serial
    reference's longest chain, the kernel's model-derived latency floor in
    ms): the model's chain of dependent root-function evaluations times
    one evaluation's latency (``cone_eval_latency``). The chain is the
    CPU model's, not counted on the card, so the floor is an estimate."""
    al = alpha.cpu() if isinstance(alpha, torch.Tensor) else alpha
    chains = cp._lane_model(blocks.cpu(), kind, al, dual)[1]
    chain = int(chains.max()) if chains.numel() else 0
    serial = cone_proj_trips(blocks, kind, alpha, dual)[1]
    return chain, serial, chain * latency[(kind, str(blocks.dtype))][1]


def _median(*xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def dm_times(dm, a, u, v):
    """dual_matvec on one f32 input, timed in turns (library, kernel,
    kernel, library, plain): device ms per call of the kernel, its plain
    version and the library call (two torch.mv, cuBLAS GEMV), by the
    profiler and by events (``stream_ms``); and the byte bound: A read
    once, u and v read, p and q written."""
    def kern():
        return dm.dual_matvec_cuda(a, u, v)

    def plain():
        return dm.dual_matvec_plain(a, u, v)

    def lib():
        return torch.mv(a, u), torch.mv(a.t(), v)

    out = {}
    for how, timer in (("device", device_ms), ("events", stream_ms)):
        l1, k1, k2, l2, p1 = (timer(f) for f in (lib, kern, kern, lib, plain))
        out[how] = (_median(k1, k2), p1, _median(l1, l2))
    m, n = a.shape
    out["bound"] = bound_ms(a.element_size() * m * n
                            + u.element_size() * 2 * (m + n), 4 * m * n)
    return out


def fmt_dm_times(what, t):
    """One line of ``dm_times``: times in us, the kernel's share of the
    byte bound, and whether it beat the library call."""
    def us(x):
        return "n/a" if x is None else f"{1e3 * x:.2f}"
    k, p, lib = t["device"]
    share = "n/a" if k is None else f"{100 * t['bound'][0] / k:.1f}%"
    verdict = ("n/a" if k is None or lib is None
               else "kernel <= library" if k <= lib else "kernel > library")
    return (f"{what}: device us kernel/plain/two torch.mv {us(k)}/{us(p)}/"
            f"{us(lib)} (events {'/'.join(us(x) for x in t['events'])}); "
            f"bound {us(t['bound'][0])} us ({t['bound'][1]}), kernel at "
            f"{share} of it; {verdict}")


def profile_loop(fn, iters):
    """Run ``fn()`` (``iters`` pdhg iterations) under torch.profiler:
    (wall us, device-busy us, kernel launches) per iteration, from the
    kernel rows only."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows)
    count = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:4]
    return (1e6 * wall / iters, busy / iters, count / iters,
            [(e.key[:40], e.self_device_time_total / iters) for e in top])


def drive(paths, kernels, spans=None):
    """Run each main path once, every kernel's launch count set to 0 just
    before it and read just after: name -> (result, wall seconds, launch
    counts, the spans ``time_calls`` recorded during the path)."""
    runs = {}
    for name, run in paths.items():
        for mod in kernels.values():
            mod.launches = 0
        if spans is not None:
            spans.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = (res, wall, {k: mod.launches
                                  for k, mod in kernels.items()},
                      list(spans or []))
        print(f"  main path {name}: status {res.status}, {res.iters} "
              f"iterations, {wall:.3f} s, launches {runs[name][2]}",
              flush=True)
    return runs


def time_calls(module, names, spans):
    """Replace the functions ``names`` of ``module`` by copies that
    synchronize the card around each call and append (name, seconds,
    result) to ``spans``; returns the originals, to put back."""
    real = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def timed_call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans.append((name, time.perf_counter() - t0, out))
            return out
        return timed_call

    for name, fn in real.items():
        setattr(module, name, wrap(name, fn))
    return real


def span_ms(spans, name):
    """Milliseconds of the calls of ``name`` among ``spans``."""
    return 1e3 * sum(t for n, t, _ in spans if n == name)


def lp_kkt(c, a, b, x, y):
    """An LP's residuals in f64 on the host, from x and y (A x + s = b,
    s >= 0; y >= 0): primal ||max(A x - b, 0)|| / (1 + ||b||), dual
    ||(A^T y + c, min(y, 0))|| / (1 + ||c||) and the gap |c^T x + b^T y|
    / (1 + |c^T x| + |b^T y|). ``a`` dense, or a scipy sparse matrix
    (kept sparse)."""
    from scipy import sparse
    c, b, x, y = (np.asarray(v, dtype=np.float64) for v in (c, b, x, y))
    a = a.astype(np.float64) if sparse.issparse(a) \
        else np.asarray(a, dtype=np.float64)
    pri = np.linalg.norm(np.maximum(a @ x - b, 0.0)) / (1.0 + np.linalg.norm(b))
    dual = np.linalg.norm(np.concatenate([a.T @ y + c, np.minimum(y, 0.0)])) \
        / (1.0 + np.linalg.norm(c))
    cx, by = float(c @ x), float(b @ y)
    gap = abs(cx + by) / (1.0 + abs(cx) + abs(by))
    return pri, dual, gap


# the fields two SolveResults must share bit for bit
RESULT_TENSORS = ("x", "y", "cri_pri", "cri_dual", "cri_gap", "cri_unbdd",
                  "cri_infeas")


def bitwise_diff(r1, r2):
    """The fields in which two SolveResults differ: the status and every
    tensor of RESULT_TENSORS, compared bit for bit."""
    out = [] if r1.status == r2.status else ["status"]
    return out + [f for f in RESULT_TENSORS
                  if not torch.equal(getattr(r1, f), getattr(r2, f))]


def split_solve(solve, param, k=1000):
    """(k, whole, first, second): ``solve(param, **kw)`` run once for 2k
    iterations, and as k iterations with ``return_state`` resumed for k
    more. k is a multiple of the check period (a loop stops on a check),
    the largest up to ``k`` with the whole solve still EXCESS_ITER (a
    solve that converges before 2k is split inside its run)."""
    def run(max_iter, **kw):
        return solve(dataclasses.replace(param, max_iter=max_iter,
                                         return_state=True), **kw)

    from totsu_tpu_torch import SolverStatus
    cp = max(1, param.check_period)
    k = cp * (k // cp)
    whole = run(2 * k)
    if whole.status != SolverStatus.EXCESS_ITER:
        k = cp * ((whole.iters - 1) // (2 * cp))
        check(k > 0, f"a solve of {whole.iters} iterations cannot be split")
        whole = run(2 * k)
    first = run(k)
    second = run(k, resume_state=first.state)
    return k, whole, first, second


def log_ks(text):
    """The iteration count at the head of each progress line in ``text``
    (``"{k}: ..."``, as the host loops print them)."""
    return [int(m) for m in re.findall(r"^(\d+): ", text, re.M)]


def logged_ks(iters, check_period, log_period, k_start=0):
    """The checks of a host loop from ``k_start`` to ``k_start + iters``
    that print a progress line."""
    return [k for k in range(k_start + check_period, k_start + iters + 1,
                             check_period)
            if (k - check_period) % log_period < check_period]


def kernel_rows(fn, calls=20):
    """The profiler's kernel rows of ``calls`` calls of ``fn()``: (name,
    device us per call), the longest first. A window can lose kernel
    records, so each kernel counts at its mean time per record times its
    records per call, rounded up (as in ``device_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / e.count
             * -(-e.count // calls))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.count > 0 and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def operator_errors(op, dense, rng):
    """``op`` against the dense twin of its ``to_dense()`` on the same
    device: the largest error of to_dense against ``dense`` (the host's
    numpy matrix), and of matvec, rmatvec, the absolute sums and maxima,
    col_sqsum and diag_scale (through a matvec) against the twin, each
    relative to the largest entry of its reference."""
    import totsu_tpu_torch as tt
    m, n = dense.shape
    dev = op.device
    got = op.to_dense()
    twin = tt.DenseOp(got)

    def vec(k, lo=-1.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, size=k), dtype=got.dtype,
                            device=dev)

    x, y, d, e = vec(n), vec(m), vec(m, 0.5, 1.5), vec(n, 0.5, 1.5)
    pairs = {
        "to_dense": (got, torch.from_numpy(dense).to(dev)),
        "matvec": (op.matvec(x), twin.matvec(x)),
        "rmatvec": (op.rmatvec(y), twin.rmatvec(y)),
        "col_abssum": (op.col_abssum(), twin.col_abssum()),
        "row_abssum": (op.row_abssum(), twin.row_abssum()),
        "row_absmax": (op.row_absmax(), twin.row_absmax()),
        "col_absmax": (op.col_absmax(), twin.col_absmax()),
        "col_sqsum": (op.col_sqsum(), twin.col_sqsum()),
        "diag_scale": (op.diag_scale(d, e).matvec(x),
                       twin.diag_scale(d, e).matvec(x)),
    }
    return {k: float((a - b).abs().max() / max(1.0, float(b.abs().max())))
            for k, (a, b) in pairs.items()}


def structured_phases(tt, dev, kernels, n20=65_536, n21=4096, n21b=8192,
                      n22=65_536, pdhg_iters=2000):
    """Phases 20-22: the structured operators and the indirect engine at
    full width (the sizes are arguments only so that the flow can be
    rehearsed small). Each path is driven once through solve() /
    solve_jit(), the launch counts set to 0 just before it; returns the
    kernels' launch counts over these paths (the structured path launches
    none of the three kernels: a stack's dual_matvec is matvec plus
    rmatvec, and the megakernel takes a dense A only)."""
    import warnings
    from scipy import sparse
    from scipy.optimize import linprog
    from totsu_tpu_torch.solver import conic as tconic
    from totsu_tpu_torch.solver import direct as tdirect
    from totsu_tpu_torch.solver.scaling import scaling_spread
    f32 = torch.float32
    rep = dataclasses.replace
    counts = {k: 0 for k in kernels}

    def count(runs):
        for r in runs.values():
            for k in kernels:
                counts[k] += r[2][k]
        return {k: sum(r[2][k] for r in runs.values()) for k in kernels}

    def objective(cvec, res):
        return float(np.dot(np.asarray(cvec, np.float64),
                            res.x.double().cpu().numpy()))

    def rel(got, want):
        return abs(got - want) / max(1.0, abs(want))

    # ---- phase 20: bench.py's from-tiles banded LP at full width: A =
    # [band; I; -I] (m = 3n), the band block-tridiagonal from 128 x 128
    # tiles, never dense; the indirect engine (method='direct', Halpern)
    t0 = time.perf_counter()
    tiles, b20, c20 = make_tiles_lp(n20)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    band = tt.BlockedEllOp.from_tiles(tiles, m=n20, n=n20, block=(128, 128),
                                      device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    a20_host = tiles_box_csr(tiles, n20, 128)
    del tiles
    tile_mb = (band.blocks.numel() + band.blocks_t.numel()) * 4 / 1e6
    ones = torch.ones(n20, dtype=f32, device=dev)
    a20 = tt.VStackOp((band, tt.DiagOp(ones), tt.DiagOp(-ones)))
    c20t = torch.from_numpy(c20).to(dev)
    b20t = torch.from_numpy(b20).to(dev)
    cone20 = tt.ConeLayout([tt.rpos(3 * n20)])
    p20 = tt.SolverParam(max_iter=8000, eps_acc=1e-3, check_period=20,
                         method="direct", accel="halpern")
    kept = {}

    def whole():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = tt.solve(c20t, a20, b20t, cone20, p20)
        kept["warnings"] = [str(w.message) for w in seen
                            if issubclass(w.category, RuntimeWarning)]
        return out

    def split():
        kept["first"] = tt.solve_jit(c20t, a20, b20t, cone20,
                                     rep(p20, max_iter=100,
                                         return_state=True))
        return tt.solve_jit(c20t, a20, b20t, cone20, p20,
                            resume_state=kept["first"].state)

    spans20 = []
    real20 = time_calls(tdirect, ("_run_halpern_dr",), spans20)
    try:
        runs20 = drive({
            "whole": whole,
            "repeat": lambda: tt.solve_jit(c20t, a20, b20t, cone20, p20),
            "split at 100": split,
            "chunks of 100": lambda: tt.solve(c20t, a20, b20t, cone20, p20,
                                              chunk_iters=100),
        }, kernels, spans20)
    finally:
        for name, fn in real20.items():
            setattr(tdirect, name, fn)
    cnt20 = count(runs20)
    r20, wall20, _, sp20 = runs20["whole"]
    check(r20.converged, f"tiles LP status {r20.status}")
    kkt20 = lp_kkt(c20, a20_host, b20, r20.x.cpu().numpy(),
                   r20.y.cpu().numpy())
    check(max(kkt20) <= 2e-3, f"tiles LP residuals (primal, dual, gap) "
          f"{kkt20}")
    worst20 = float(r20.diag["cg_worst_rel"])
    tol20 = float(r20.diag["cg_tol"])
    check(worst20 <= 10.0 * tol20 and not any(
        "CG" in w for w in kept["warnings"]),
        f"tiles LP CG worst relative residual {worst20:.2e} vs target "
        f"{tol20:.2e}; warnings {kept['warnings']}")
    r_rep = runs20["repeat"][0]
    r_spl = runs20["split at 100"][0]
    r_chk = runs20["chunks of 100"][0]
    first = kept["first"]
    for what, r, iters in (("repeat", r_rep, r_rep.iters),
                           ("split at 100", r_spl, first.iters + r_spl.iters),
                           ("chunks of 100", r_chk, r_chk.iters)):
        diff = bitwise_diff(r, r20)
        check(iters == r20.iters and diff == [],
              f"tiles LP {what}: {iters} iterations (whole {r20.iters}), "
              f"differs in {diff}")
    check(all(v == 0 for v in cnt20.values()),
          f"the structured path launched kernels: {cnt20}")
    loop20 = span_ms(sp20, "_run_halpern_dr")
    x = torch.randn(n20, dtype=f32, device=dev)
    y = torch.randn(n20, dtype=f32, device=dev)
    ell_us = {}
    for what, fn in (("matvec", lambda: band.matvec(x)),
                     ("rmatvec", lambda: band.rmatvec(y))):
        dev_ms = device_ms(fn)
        ev_ms = stream_ms(fn)
        rows = kernel_rows(fn)
        # a copy of the tiles would take about as long as the product
        check(all(t <= 0.25 * rows[0][1] for _, t in rows[1:]),
              f"ELL {what}: a second kernel of tile size: {rows}")
        ell_us[what] = (dev_ms, ev_ms, rows)
    ell_bound = bound_ms(band.blocks.numel() * 4 + 8 * n20,
                         2 * band.blocks.numel())
    # 20 DR iterations of the loop alone, resumed from the split's
    # checkpoint at k = 100, under torch.profiler
    stats, out = [], []
    real_loop = tdirect._run_halpern_dr

    def profiled_loop(*args, **kwargs):
        stats.append(profile_loop(
            lambda: out.append(real_loop(*args, **kwargs)), 20))
        return out[0]

    tdirect._run_halpern_dr = profiled_loop
    try:
        r20p = tt.solve_jit(c20t, a20, b20t, cone20, rep(p20, max_iter=20),
                            resume_state=first.state)
    finally:
        tdirect._run_halpern_dr = real_loop
    wall_us, busy_us, nlaunch, top = stats[0]
    d20 = r20.diag
    print(f"phase 20 from-tiles banded LP n={n20} (A {3 * n20}x{n20} f32: "
          f"[band; I; -I], {band.blocks.shape[0] * band.blocks.shape[2]} "
          f"tile slots, {tile_mb:.1f} MB of tiles on the card; generated "
          f"{gen_s:.1f} s, from_tiles {build_s:.1f} s), method='direct' "
          f"Halpern: CONVERGED in {r20.iters} DR iterations, "
          f"{1e3 * wall20:.1f} ms ({1e6 * wall20 / r20.iters:.1f} us per DR "
          f"iteration; loop {loop20:.1f} ms, {1e3 * loop20 / r20.iters:.1f} "
          f"us per iteration); CG: {d20['cg_setup_steps']} steps in the "
          f"border's solve, {d20['cg_steps']} in {d20['cg_solves']} "
          f"resolvents ({d20['cg_steps'] / r20.iters:.2f} per DR iteration,"
          f" {d20['cg_steps'] / d20['cg_solves']:.2f} per resolvent), worst "
          f"relative residual {worst20:.2e} vs target {tol20:.2e}; host f64 "
          f"residuals primal {kkt20[0]:.2e}, dual {kkt20[1]:.2e}, gap "
          f"{kkt20[2]:.2e}; repeat, split at {first.iters} + "
          f"{r_spl.iters} and chunks of 100 bitwise the whole solve "
          f"(chunked {1e3 * runs20['chunks of 100'][1]:.1f} ms); launches "
          f"{cnt20}", flush=True)
    def us(ms):
        return "n/a" if ms is None else f"{1e3 * ms:.2f}"

    for what, (dev_ms, ev_ms, rows) in ell_us.items():
        print(f"  ELL {what} (n={n20}): device {us(dev_ms)} us per call "
              f"(events {us(ev_ms)} us), bound {us(ell_bound[0])} us "
              f"({ell_bound[1]}); "
              "kernels " + ", ".join(f"{k[:48]} {t:.2f} us"
                                     for k, t in rows[:3]), flush=True)
    print(f"  profile 20 DR iterations from k={first.state.k}: "
          f"{wall_us:.1f} us wall and {busy_us:.1f} us device-busy per "
          f"iteration ({100 * busy_us / wall_us:.1f}% busy), {nlaunch:.1f} "
          f"kernel launches per iteration, {r20p.diag['cg_steps'] / 20:.2f} "
          "CG steps per iteration; top kernels (us per iteration) "
          + ", ".join(f"{k} {t:.1f}" for k, t in top), flush=True)
    del a20_host

    # ---- phase 21: benchmark_indirect.py's banded box LP (n = 4096) as a
    # BlockedEllOp under profile='fast' (routed to the indirect engine
    # with Halpern, equil_iters unset), against HiGHS; then
    # benchmark_sparse.py's banded LP (n = 8192) as a BlockedEllOp on the
    # pdhg host loop with bench.py's ell8192 parameters (at most 2,000
    # iterations, eps_acc 1e-12, a check every 100). That LP has no box
    # rows: it is unbounded, and the solve certifies so after a few
    # checks, as the JAX package's does
    c21, a21, b21 = make_banded_box_lp(n21)
    ell21 = tt.BlockedEllOp.from_dense(a21, block=(128, 128), device=dev)
    c21t = torch.from_numpy(c21).to(dev)
    b21t = torch.from_numpy(b21).to(dev)
    cone21 = tt.ConeLayout([tt.rpos(3 * n21)])
    p21 = tt.SolverParam(max_iter=400_000, eps_acc=1e-3, profile="fast")
    spread21 = scaling_spread(ell21)
    p21r = tconic._resolve_fast_profile(
        tconic._maybe_auto_equil(p21, ell21, None), ell21, cone21)
    check((p21r.method, p21r.accel, p21r.equil_iters)
          == ("direct", "halpern", None), f"fast profile on ELL: {p21r}")
    cb, ab, bb = make_banded_lp(n21b, k_tiles=2)
    ell21b = tt.BlockedEllOp.from_dense(ab, block=(128, 128), device=dev)
    del ab
    cbt, bbt = torch.from_numpy(cb).to(dev), torch.from_numpy(bb).to(dev)
    cone21b = tt.ConeLayout([tt.rpos(n21b)])
    p21b = tt.SolverParam(max_iter=pdhg_iters, eps_acc=1e-12,
                          check_period=100)
    runs21 = drive({
        "box LP ELL, fast profile":
            lambda: tt.solve(c21t, ell21, b21t, cone21, p21),
        "banded LP ELL, pdhg host loop":
            lambda: tt.solve_jit(cbt, ell21b, bbt, cone21b, p21b),
        "banded LP ELL, pdhg host loop, repeat":
            lambda: tt.solve_jit(cbt, ell21b, bbt, cone21b, p21b),
    }, kernels)
    cnt21 = count(runs21)
    r21, wall21, _, _ = runs21["box LP ELL, fast profile"]
    check(r21.converged, f"banded box LP status {r21.status}")
    obj21 = objective(c21, r21)
    t0 = time.perf_counter()
    hi21 = linprog(c21.astype(np.float64),
                   A_ub=sparse.csr_matrix(a21.astype(np.float64)),
                   b_ub=b21.astype(np.float64), bounds=(None, None),
                   method="highs-ipm")
    highs21_s = time.perf_counter() - t0
    check(hi21.status == 0, f"HiGHS status {hi21.status}: {hi21.message}")
    check(rel(obj21, hi21.fun) <= 5e-3, f"banded box LP objective {obj21} "
          f"vs HiGHS {hi21.fun}")
    r21b, wall21b, _, _ = runs21["banded LP ELL, pdhg host loop"]
    r21c, wall21c, _, _ = runs21["banded LP ELL, pdhg host loop, repeat"]
    diff21 = bitwise_diff(r21c, r21b)
    check(r21b.status in (tt.SolverStatus.EXCESS_ITER,
                          tt.SolverStatus.UNBOUNDED)
          and r21c.iters == r21b.iters and diff21 == [],
          f"pdhg on ELL: status {r21b.status}, {r21b.iters}/{r21c.iters} "
          f"iterations, repeat differs in {diff21}")
    check(all(v == 0 for v in cnt21.values()),
          f"the structured path launched kernels: {cnt21}")
    wall_b, busy_b, nl_b, top_b = profile_loop(
        lambda: tt.solve_jit(cbt, ell21b, bbt, cone21b,
                             rep(p21b, max_iter=200)), 200)
    print(f"phase 21 banded box LP n={n21} (A {3 * n21}x{n21} f32 as "
          f"BlockedEllOp, K={ell21.cols.shape[1]}), profile='fast' "
          f"(column spread {spread21:.2f}) -> method={p21r.method!r} "
          f"accel={p21r.accel!r} check_period={p21r.check_period} "
          f"equil_iters={p21r.equil_iters}: CONVERGED in {r21.iters} "
          f"iterations, {1e3 * wall21:.1f} ms; objective {obj21:.6f} vs "
          f"HiGHS {hi21.fun:.6f} (rel {rel(obj21, hi21.fun):.2e}, HiGHS "
          f"{highs21_s:.1f} s); banded LP n={n21b} (K="
          f"{ell21b.cols.shape[1]}) on the pdhg host loop: "
          f"{tt.SolverStatus(r21b.status).name} after {r21b.iters} "
          f"iterations, {wall21b:.3f} s ({r21b.iters / wall21b:.1f} "
          f"iterations/s; repeat {r21c.iters / wall21c:.1f}), repeat "
          f"bitwise; profile of 200 iterations: {wall_b:.1f} us wall, "
          f"{100 * busy_b / wall_b:.1f}% busy, {nl_b:.1f} launches per "
          f"iteration (setup included); launches {cnt21}", flush=True)

    # ---- phase 22: the other operators on the card against their dense
    # twins; the matrix-free stencil LP (n = 65,536) as a CustomOp on the
    # indirect engine with the hand-written and the autograd adjoint; the
    # n = 4096 banded box LP as a SparseOp against phase 21's ELL solve
    rng = np.random.default_rng(22)
    band21 = np.ascontiguousarray(a21[:n21])
    ell_band = tt.BlockedEllOp.from_dense(band21, block=(128, 128),
                                          device=dev)
    dd = (rng.random(n21) + 0.5).astype(np.float32)
    ones21 = torch.ones(n21, dtype=f32, device=dev)
    dd_t = torch.from_numpy(dd).to(dev)
    sparse21 = tt.SparseOp.from_dense(torch.from_numpy(a21).to(dev))
    zeros21 = np.zeros((n21, n21), np.float32)
    ops22 = {
        "SparseOp": (sparse21, a21),
        "BlockedEllOp": (ell21, a21),
        "VStackOp": (tt.VStackOp((ell_band, tt.DiagOp(ones21),
                                  tt.DiagOp(-ones21))), a21),
        "HStackOp": (tt.HStackOp((ell_band, tt.DiagOp(dd_t))),
                     np.hstack([band21, np.diag(dd)])),
        "BlockOp": (tt.BlockOp([[ell_band, tt.ZeroOp(n21, n21, device=dev)],
                                [tt.DiagOp(ones21), tt.DiagOp(dd_t)]]),
                    np.block([[band21, zeros21],
                              [np.eye(n21, dtype=np.float32), np.diag(dd)]])),
        "ScaledOp": (tt.ScaledOp(-2.5, ell_band),
                     (np.float32(-2.5) * band21)),
        "DiagOp": (tt.DiagOp(dd_t), np.diag(dd)),
    }
    errs22 = {}
    for what, (op, dense) in ops22.items():
        errs = operator_errors(op, dense, rng)
        worst = max(errs, key=errs.get)
        check(errs[worst] <= 1e-4, f"{what} against its dense twin: {errs}")
        errs22[what] = (worst, errs[worst])
    del ops22, zeros21
    p22 = tt.SolverParam(max_iter=400_000, eps_acc=1e-3, check_period=20,
                         method="direct", accel="halpern")
    stencils = {adj: make_stencil_lp(tt, n22, dev, adjoint=adj)
                for adj in (True, False)}
    cone22 = tt.ConeLayout([tt.rpos(3 * n22)])
    def stencil_solve(adjoint):
        c_, op_, b_ = stencils[adjoint]
        return lambda: tt.solve(c_, op_, b_, cone22, p22)

    runs22 = drive({
        "stencil LP CustomOp, hand adjoint": stencil_solve(True),
        "stencil LP CustomOp, autograd adjoint": stencil_solve(False),
        "box LP SparseOp, fast profile":
            lambda: tt.solve(c21t, sparse21, b21t, cone21, p21),
        "box LP SparseOp, fast profile, repeat":
            lambda: tt.solve(c21t, sparse21, b21t, cone21, p21),
    }, kernels)
    cnt22 = count(runs22)
    r_hand, wall_hand, _, _ = runs22["stencil LP CustomOp, hand adjoint"]
    r_auto, wall_auto, _, _ = runs22["stencil LP CustomOp, autograd adjoint"]
    o_hand = objective(stencils[True][0].cpu().numpy(), r_hand)
    o_auto = objective(stencils[False][0].cpu().numpy(), r_auto)
    check(r_hand.converged and r_auto.converged
          and rel(o_auto, o_hand) <= 1e-4,
          f"stencil LP: statuses {r_hand.status}/{r_auto.status}, "
          f"objectives {o_hand}/{o_auto}")
    r_sp, wall_sp, _, _ = runs22["box LP SparseOp, fast profile"]
    r_sp2 = runs22["box LP SparseOp, fast profile, repeat"][0]
    o_sp = objective(c21, r_sp)
    check(r_sp.converged and rel(o_sp, obj21) <= 1e-3,
          f"SparseOp banded box LP: status {r_sp.status}, objective {o_sp} "
          f"vs ELL {obj21}")
    sp_diff = bitwise_diff(r_sp2, r_sp)
    check(all(v == 0 for v in cnt22.values()),
          f"the structured path launched kernels: {cnt22}")
    print("phase 22 operators against their dense twins (largest relative "
          "error, f32): " + ", ".join(
              f"{k} {v[1]:.1e} ({v[0]})" for k, v in errs22.items())
          + f"; stencil LP n={n22} (CustomOp, plain CG): hand adjoint "
          f"{r_hand.iters} iterations, {1e3 * wall_hand:.1f} ms, "
          f"{r_hand.diag['cg_steps'] / r_hand.iters:.2f} CG steps per "
          f"iteration; autograd adjoint {r_auto.iters} iterations, "
          f"{1e3 * wall_auto:.1f} ms; objectives {o_hand:.6f} / "
          f"{o_auto:.6f} (rel {rel(o_auto, o_hand):.1e}); SparseOp banded "
          f"box LP n={n21}: {r_sp.iters} iterations, {1e3 * wall_sp:.1f} ms,"
          f" objective {o_sp:.6f} vs ELL {obj21:.6f} (rel "
          f"{rel(o_sp, obj21):.1e}); repeat "
          + ("bitwise" if not sp_diff and r_sp2.iters == r_sp.iters
             else f"not bitwise ({r_sp2.iters} iterations, differs in "
                  f"{sp_diff})")
          + f"; launches {cnt22}", flush=True)
    return counts


# ---- phases 23-26: the PSD and custom cones, the SDP, SOCP and QCQP
# builders

#: the CPU references' sizes: phase 4's LP, phases 24-26's partitioning
#: SDP grid (k = 48), torus SOCP and trajectory QCQP
REF_KW = dict(lp_n=1000, grid24=(8, 6), torus=(9, 7), traj=(30, 90.0))

#: phase 23's (k, count): the nearest-correlation solves' launch (one
#: instance a solve; the kernels record's row), the lockstep batch of 16,
#: the auto rule's regime (k <= 16, count >= 64), the reference's
#: partitioning order and benchmark_sdp.py's larger ones (phase 25
#: launches (128, 1))
PHASE23_SHAPES = ((8, 1), (8, 16), (8, 512), (16, 64), (48, 1), (128, 1),
                  (128, 16), (256, 1))


def cpu_references(lp_n, grid24, torus, traj, cores=None):
    """The CPU references of phases 4 and 24-26, in f64 (this runs in a
    child process beside the card's phases, on the CPU only, pinned to
    ``cores`` where given; the cores it ran on come back as ``cores``):
    * HiGHS on phase 4's n = ``lp_n`` benchmark LP: status, message,
      objective, x and its seconds;
    * the partitioning SDP's objective <W, X> from the port's f64 solve
      at eps_acc 1e-6 (the structured form of phase 25, the same problem
      as phase 24's dense one: [diag(-dscale); selection] is the dense
      A's own matrix), pdhg with Halpern, check_period 20;
    * the torus SOCP's objective from the port's f64 solve at eps_acc
      1e-6 (profile='fast');
    * the trajectory QCQP's objective from SLSQP (the port's f64 solve
      takes more than 170,000 iterations there)."""
    if cores:
        os.sched_setaffinity(0, cores)
    import totsu_tpu_torch as tt
    from scipy.optimize import linprog, minimize
    torch.set_num_threads(2)
    cpu, f64 = torch.device("cpu"), torch.float64
    c1, a1, b1 = make_lp(lp_n)
    t0 = time.perf_counter()
    hi = linprog(c1.astype(np.float64), A_ub=a1.astype(np.float64),
                 b_ub=b1.astype(np.float64), bounds=(None, None),
                 method="highs")
    lp = {"status": hi.status, "message": hi.message, "fun": hi.fun,
          "x": None if hi.x is None else hi.x.tolist(),
          "seconds": time.perf_counter() - t0}
    x_num, y_num = grid24
    w, c, neg_d, sel, b = make_partitioning_structured(x_num * y_num)
    l = w.shape[0]
    op = tt.VStackOp((tt.DiagOp(torch.tensor(neg_d, dtype=f64)),
                      tt.DenseOp(torch.tensor(sel, dtype=f64))))
    r = tt.solve_jit(torch.tensor(c, dtype=f64), op,
                     torch.tensor(b, dtype=f64),
                     tt.ConeLayout([tt.psd(l, method="eigh"), tt.zero(l)]),
                     tt.SolverParam(max_iter=200_000, eps_acc=1e-6,
                                    accel="halpern", check_period=20))
    out = {"lp": lp, "partitioning": float(np.trace(w @ packed_matrix(
        r.x.numpy(), l))), "partitioning_iters": r.iters,
        "partitioning_status": r.status,
        "cores": sorted(os.sched_getaffinity(0))}
    f, g_l, h_l, c_l, d_l, a, b, l_t, _ = make_torus(*torus)
    rt = tt.problems.socp(f, g_l, h_l, c_l, d_l, a, b, device=cpu).solve_jit(
        tt.SolverParam(max_iter=200_000, eps_acc=1e-6, profile="fast"))
    out.update(torus=float(rt.x[2 * l_t:].sum()), torus_iters=rt.iters,
               torus_status=rt.status)
    p_mats, _, r_scls, a, b = make_trajplan(*traj)
    cons = [{"type": "eq", "fun": lambda x: a @ x - b, "jac": lambda x: a}]
    cons += [{"type": "ineq",
              "fun": lambda x, i=i: -(0.5 * x @ p_mats[i] @ x + r_scls[i]),
              "jac": lambda x, i=i: -(p_mats[i] @ x)}
             for i in range(1, len(p_mats))]
    res = minimize(lambda x: 0.5 * x @ p_mats[0] @ x,
                   np.linalg.lstsq(a, b, rcond=None)[0],
                   jac=lambda x: p_mats[0] @ x, constraints=cons,
                   method="SLSQP", options=dict(maxiter=1000, ftol=1e-12))
    viol = max(0.5 * res.x @ p_mats[i] @ res.x + r_scls[i]
               for i in range(1, len(p_mats)))
    out.update(traj=float(res.fun), traj_viol=float(max(
        viol, np.abs(a @ res.x - b).max())))
    return out


def start_cpu_references(**kw):
    """:func:`cpu_references` in a child process that sees no card; its
    JSON comes back on the child's standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-references",
         json.dumps(kw)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT)


def psd_jacobi_bound(pj, k, count, dtype, sweeps=None):
    """Kernel J's bound: the packed blocks read and written once (bytes)
    against the operations of the algorithm (``psd_jacobi.ops_count``)."""
    from totsu_tpu_torch.ops import jacobi
    elem = torch.empty(0, dtype=dtype).element_size()
    return bound_ms(2 * count * (k * (k + 1) // 2) * elem,
                    pj.ops_count(k, count, jacobi.sweeps_for(k, sweeps)),
                    dtype)


def psd_jacobi_switches(pj, smem, sms, counts=(1, 132)):
    """The smallest shape (k, count), over ``counts`` in turn, at which
    ``psd_jacobi.plan`` picks each of its layouts (shared memory or
    global, A whole in each CTA or split over the cluster, the cluster,
    slots held in registers or read from the table)
    in f32 or f64, on a card of ``sms`` SMs and ``smem`` bytes of shared
    memory per block, less those of ``PHASE23_SHAPES``."""
    seen, shapes = set(), []
    for cnt in counts:
        for k in range(1, pj.MAX_K + 1):
            for dt in (torch.float32, torch.float64):
                pl = pj.plan(k, cnt, dt, smem, sms)
                key = (pl.smem_layout, pl.split, pl.cluster, pl.held)
                if key not in seen:
                    seen.add(key)
                    if (k, cnt) not in shapes + list(PHASE23_SHAPES):
                        shapes.append((k, cnt))
    return shapes


def psd_jacobi_phase(dev, shapes=PHASE23_SHAPES, switches=True):
    """Phase 23: kernel J against its plain version on the card at each
    (k, count) of ``shapes`` and, on the card with ``switches``, at the
    smallest shape of each further layout of its plan
    (:func:`psd_jacobi_switches`; 16 sweeps past k = 256, where the sweep
    count is the caller's), in f32 and f64 (the error relative to
    ||X||_F, a repeat bitwise), with its plan, its time by CUDA events,
    the plain version's (wall), the library's (torch.linalg.eigh, clamp,
    rebuild: device and wall, its host sync included), 'ns' and the
    bound (at a switch's shape the kernel's time alone). Returns the rows
    by (k, count, dtype)."""
    from totsu_tpu_torch.ops import sympack
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj
    f32, f64 = torch.float32, torch.float64
    on_card = dev.type == "cuda"

    def us(x):
        return "n/a" if x is None else f"{1e3 * x:.2f}"

    def card_plan(k, cnt, dt):
        return pj.device_plan(k, cnt, dt, dev) if on_card else \
            pj.plan(k, cnt, dt, 232_448)

    shapes, extra = list(shapes), []
    if on_card and switches:
        extra = psd_jacobi_switches(pj, *pj.card_limits(dev))
        print(f"phase 23 layout switches of the plan (k, count): {extra}",
              flush=True)
        shapes += extra
    rng = np.random.default_rng(23)
    tol23 = {f32: 1e-5, f64: 1e-12}
    rows23 = {}
    for k, cnt in shapes:
        sweeps = None if k <= 256 else 16
        for dt in (f32, f64):
            v = torch.tensor(rng.normal(size=(cnt, k * (k + 1) // 2)),
                             dtype=dt, device=dev)
            scale = float(torch.linalg.vector_norm(v, dim=1).max())
            out = pj.proj_psd_jacobi_cuda(v, sweeps=sweeps)
            again = pj.proj_psd_jacobi_cuda(v, sweeps=sweeps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = pj.proj_psd_jacobi_plain(v, sweeps=sweeps)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            eigh = sympack.proj_psd_packed(v, method="eigh")
            err = float((out - plain).abs().max())
            err_eigh = float((out - eigh).abs().max()) / scale
            check(err <= tol23[dt] * scale and torch.equal(out, again),
                  f"psd_jacobi k={k} count={cnt} {dt}: max error "
                  f"{err / scale:.2e} of ||X||_F against the plain "
                  f"version (limit {tol23[dt]:.0e}); repeat bitwise "
                  f"{torch.equal(out, again)}")
            def kern():
                return pj.proj_psd_jacobi_cuda(v, sweeps=sweeps)

            def lib():
                return sympack.proj_psd_packed(v, method="eigh")

            def ns():
                return sympack.proj_psd_packed(v, method="ns")

            if (k, cnt) in extra:  # a layout's check: its time alone
                kern_ms = stream_ms(kern, 1)
                lib_dev = lib_wall = ns_ms = None
            else:
                one_ms, _ = sync_time(kern, 1)
                calls = max(3, min(50, int(0.3 / max(one_ms, 1e-6))))
                kern_ms = _median(stream_ms(kern, calls),
                                  stream_ms(kern, calls))
                lib_dev = device_ms(lib, calls=min(calls, 10), windows=1)
                lib_wall = 1e3 * sync_time(lib, 5)[0]
                # about 110 launches a call: few calls, so that the host
                # queues them all behind the sleeping kernel
                ns_ms = stream_ms(ns, 3)
            bound = psd_jacobi_bound(pj, k, cnt, dt, sweeps)
            pl = card_plan(k, cnt, dt)
            rows23[(k, cnt, dt)] = dict(err=err, rel=err / scale,
                                        ms=kern_ms, plain_ms=plain_ms,
                                        lib_ms=lib_dev, lib_wall=lib_wall,
                                        ns_ms=ns_ms, bound=bound,
                                        plan=pl.describe())
            print(f"  psd_jacobi k={k} count={cnt} {str(dt)[6:]}: "
                  f"{pl.describe()}; max error {err / scale:.2e} of "
                  f"||X||_F vs plain ({err_eigh:.2e} vs eigh); us kernel "
                  f"(events) {us(kern_ms)}, plain (wall) {us(plain_ms)}, "
                  f"eigh+clamp+rebuild device {us(lib_dev)} / wall "
                  f"{us(lib_wall)}, ns (events) {us(ns_ms)}; bound "
                  f"{us(bound[0])} ({bound[1]})", flush=True)
    worst = {dt: max(r["rel"] for (_, _, d), r in rows23.items() if d == dt)
             for dt in (f32, f64)}
    print(f"phase 23 psd_jacobi vs plain: ok at {len(shapes)} shapes "
          f"(k, count) {list(shapes)} in f32 and f64; worst error "
          f"{worst[f32]:.2e} (f32) and {worst[f64]:.2e} (f64) of ||X||_F",
          flush=True)
    return rows23


def sdp_phases(tt, dev, kernels, refs, shapes23=PHASE23_SHAPES,
               grid24=(8, 6), ks25=(48, 128, 256), iters25=(500, 200),
               prof_iters25=20, cov=(16, 8), traj=(30, 90.0),
               torus=(9, 7)):
    """Phases 23-26: kernel J against its plain version at phase 23's
    shapes, then the SDP, SOCP and QCQP paths (the sizes are arguments
    only so that the flow can be rehearsed small). ``refs()`` returns the
    CPU references (:func:`cpu_references`). Each path is driven once
    through solve() / solve_jit(), the launch counts set to 0 just before
    it. Returns the kernels' launch counts over these paths and kernel
    J's entry of the kernels' record."""
    f32, f64 = torch.float32, torch.float64
    rep = dataclasses.replace
    counts = {k: 0 for k in kernels}

    def count(runs):
        for r in runs.values():
            for k in kernels:
                counts[k] += r[2][k]
        return {k: sum(r[2][k] for r in runs.values()) for k in kernels}

    def rel(got, want):
        return abs(got - want) / max(1.0, abs(want))

    rows23 = psd_jacobi_phase(dev, shapes23)

    # ---- phase 24: the reference's partitioning SDP (dense, through
    # problems.sdp: A 1224 x 1176 f32 at k = 48) under the reference
    # profile (pdhg host loop, dual_matvec) and profile='fast' (the
    # direct engine); CONVERGED, diag(X) = 1, X PSD, the objective against
    # the CPU's f64 solve
    w24, c24, f_24, a24, b24 = make_partitioning(*grid24)
    l24 = w24.shape[0]
    prob24 = tt.problems.sdp(*(torch.tensor(x, dtype=f32, device=dev)
                               for x in (c24, f_24, a24, b24)))
    p24 = tt.SolverParam(max_iter=200_000, eps_acc=1e-3)
    # diag(X) = 1: under the reference profile as far as CONVERGED
    # certifies it (the primal residual ||A x + s - b|| <= eps_acc (1 +
    # ||b||), b's norm sqrt(l)); the fast profile to 1e-3
    name24 = "partitioning SDP k=%d dense, " % l24
    diag_tol24 = {
        name24 + "reference profile":
            p24.eps_acc * (1.0 + float(np.linalg.norm(b24))),
        name24 + "profile='fast'": 1e-3}
    runs24 = drive({
        name24 + "reference profile": lambda: prob24.solve_jit(p24),
        name24 + "profile='fast'":
            lambda: prob24.solve_jit(rep(p24, profile="fast")),
    }, kernels)
    count(runs24)
    ref = refs()
    check(ref["partitioning_status"] == 1,
          f"partitioning f64 CPU reference status "
          f"{ref['partitioning_status']}")
    line24 = []
    objs24 = {}
    for name, (r, wall, cnt, _) in runs24.items():
        xm = packed_matrix(r.x.double().cpu().numpy(), l24)
        obj = float(np.trace(w24 @ xm))
        diag_err = float(np.abs(np.diag(xm) - 1.0).max())
        lam = float(np.linalg.eigvalsh(xm).min())
        fro = float(np.linalg.norm(xm))
        check(r.converged and diag_err <= diag_tol24[name]
              and lam >= -1e-3 * fro
              and rel(obj, ref["partitioning"]) <= 5e-3,
              f"{name}: status {r.status}, |diag(X) - 1| {diag_err:.2e} "
              f"(limit {diag_tol24[name]:.2e}), lambda_min {lam:.2e} "
              f"(||X||_F {fro:.2f}), objective {obj:.5f} vs the f64 reference "
              f"{ref['partitioning']:.5f}")
        objs24[name] = obj
        line24.append(f"{name.split(', ')[1]}: CONVERGED in {r.iters} "
                      f"iterations, {wall:.3f} s, objective {obj:.5f}, "
                      f"|diag(X) - 1| {diag_err:.1e} (limit "
                      f"{diag_tol24[name]:.1e}), lambda_min "
                      f"{lam:.1e}, launches {cnt}")
    print(f"phase 24 partitioning SDP k={l24} (examples/partitioning_sdp.py"
          f", A {prob24.shape[0]}x{prob24.shape[1]} f32, "
          f"{4 * prob24.shape[0] * prob24.shape[1] / 1e6:.1f} MB; psd "
          "'auto': eigh under the reference profile, ns under 'fast'): "
          + "; ".join(line24) + f"; the CPU's f64 solve "
          f"{ref['partitioning']:.5f} ({ref['partitioning_iters']} "
          "iterations at eps_acc 1e-6)", flush=True)

    # ---- phase 25: benchmark_sdp.py's structured partitioning SDP
    # (A = [diag(-dscale); the diagonal's selection] as a VStackOp):
    # converged_k48 per method (fast profile: pdhg with Halpern), then
    # time_e2e's fixed-iteration rates, then launches per iteration and
    # the busy share under the profiler at the largest k
    methods = ("eigh", "ns", "jacobi")
    structured = {}

    def structured_problem(l):
        if l not in structured:
            w, c, neg_d, sel, b = make_partitioning_structured(l)
            op = tt.VStackOp((tt.DiagOp(torch.tensor(neg_d, device=dev)),
                              tt.DenseOp(torch.tensor(sel, device=dev))))
            structured[l] = (w, torch.tensor(c, device=dev), op,
                             torch.tensor(b, device=dev))
        return structured[l]

    def solve25(l, method, param):
        _, c, op, b = structured_problem(l)
        return tt.solve_jit(c, op, b, tt.ConeLayout(
            [tt.psd(l, method=method), tt.zero(l)]), param)

    k48 = ks25[0]
    p25 = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, profile="fast")
    runs25 = drive({f"structured k={k48} {m}, profile='fast'":
                    (lambda m=m: solve25(k48, m, p25)) for m in methods},
                   kernels)
    objs25 = {}
    for m in methods:
        r, wall, cnt, _ = runs25[f"structured k={k48} {m}, profile='fast'"]
        check(r.converged, f"structured k={k48} {m}: status {r.status}")
        w = structured_problem(k48)[0]
        objs25[m] = (r.iters, wall, float(np.trace(
            w @ packed_matrix(r.x.double().cpu().numpy(), k48))))
    spread25 = max(o for _, _, o in objs25.values()) - min(
        o for _, _, o in objs25.values())
    check(spread25 <= 5e-3 * max(1.0, abs(objs25["eigh"][2])),
          f"structured k={k48}: the methods' objectives {objs25} differ by "
          f"{spread25:.2e}")
    e2e = {}
    for l, iters in zip(ks25[1:], iters25):
        p_e2e = tt.SolverParam(max_iter=iters, eps_acc=1e-12,
                               check_period=max(iters // 10, 1))
        runs = drive({f"structured k={l} {m}, {iters} iterations":
                      (lambda l=l, m=m: solve25(l, m, p_e2e))
                      for m in methods}, kernels)
        for m in methods:
            r, wall, _, _ = runs[f"structured k={l} {m}, {iters} iterations"]
            check(r.iters == iters, f"structured k={l} {m}: {r.iters} "
                  f"iterations, not {iters}")
            e2e[(l, m)] = iters / wall
        count(runs)
    prof25 = {}
    l_big = ks25[-1]
    p_prof = tt.SolverParam(max_iter=prof_iters25, eps_acc=1e-12,
                            check_period=max(prof_iters25 // 2, 1))
    for m in methods:  # each method ran at this k just before
        prof25[m] = profile_loop(lambda m=m: solve25(l_big, m, p_prof),
                                 prof_iters25)
    cnt25 = count(runs25)
    print(f"phase 25 structured partitioning SDP (benchmark_sdp.py, A = "
          f"VStackOp(DiagOp, DenseOp) f32; at k={l_big}: sn "
          f"{l_big * (l_big + 1) // 2}, m {l_big * (l_big + 1) // 2 + l_big}"
          f", a {l_big}x{l_big * (l_big + 1) // 2} selection "
          f"{4 * l_big * l_big * (l_big + 1) // 2 / 1e6:.1f} MB): "
          f"converged k={k48} (profile='fast', eps_acc 1e-3): "
          + ", ".join(f"{m} {it} iterations {wall:.3f} s objective "
                      f"{o:.5f}" for m, (it, wall, o) in objs25.items())
          + f" (spread {spread25:.1e}; the f64 reference "
          f"{ref['partitioning']:.5f}); fixed-iteration rates (solve_jit, "
          "set-up included): "
          + ", ".join(f"k={l} {m} {rate:.1f} it/s"
                      for (l, m), rate in e2e.items())
          + f"; k={l_big} under the profiler ({prof_iters25} iterations): "
          + ", ".join(f"{m} {wall_us:.0f} us/it, busy "
                      f"{100 * busy / wall_us:.1f}%, {nl:.1f} launches/it"
                      for m, (wall_us, busy, nl, _) in prof25.items())
          + f"; launches {cnt25}", flush=True)

    # ---- phase 26: the other builders and the custom cone
    n_cov, k26 = cov
    covs = make_noisy_covs(n_cov, k26)
    a26, c26, sn26 = nearestcorr_data(k26)
    a26t = torch.tensor(a26, dtype=f32, device=dev)
    c26t = torch.tensor(c26, dtype=f32, device=dev)
    p26 = tt.SolverParam(max_iter=400_000, eps_acc=1e-4, check_period=25)

    def nearestcorr(method, which):
        lay = tt.ConeLayout([tt.soc(1 + sn26), tt.psd(k26, method=method),
                             tt.zero(k26)])
        return [tt.solve_jit(c26t, a26t, torch.tensor(
            nearestcorr_b(covs[i]), dtype=f32, device=dev), lay, p26)
            for i in which]

    kept = {}

    def keep(name, fn):
        def run():
            kept[name] = fn()
            return kept[name][-1]
        return run

    p_traj, q_traj, r_traj, a_traj, b_traj = make_trajplan(*traj)
    qprob = tt.problems.qcqp(*(torch.tensor(x, dtype=f32, device=dev)
                               for x in (p_traj, q_traj, r_traj, a_traj,
                                         b_traj)))
    f_t, g_t, h_t, c_t, d_t, a_t, b_t, l_t, vlen = make_torus(*torus)
    sprob = tt.problems.socp(
        *(torch.tensor(x, dtype=f32, device=dev) for x in (f_t,)),
        [torch.tensor(x, dtype=f32, device=dev) for x in g_t],
        [torch.tensor(x, dtype=f32, device=dev) for x in h_t],
        [torch.tensor(x, dtype=f32, device=dev) for x in c_t], d_t,
        torch.tensor(a_t, dtype=f32, device=dev),
        torch.tensor(b_t, dtype=f32, device=dev))
    p_ex = tt.SolverParam(max_iter=200_000, eps_acc=1e-3)
    golden = [torch.tensor(x, dtype=f64, device=dev) for x in (
        [-1.0, 0.0], [[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]],
        [6.0, 6.0, 1.0])]
    p_gold = tt.SolverParam(max_iter=10_000)
    runs26 = drive({
        f"nearest correlation {n_cov} x k={k26}, jacobi":
            keep("jacobi", lambda: nearestcorr("jacobi", range(n_cov))),
        f"nearest correlation instance 0, k={k26}, eigh":
            keep("eigh", lambda: nearestcorr("eigh", [0])),
        # the example's own parameters on the megakernel: its plain pdhg
        # takes some 170,000 iterations (a host loop checking every one
        # would take minutes); normalize and Ruiz, which profile='fast'
        # adds, let the relative criteria stop far from the example's
        # limits on this badly scaled instance
        "trajectory QCQP, megakernel":
            lambda: qprob.solve_jit(rep(p_ex, kernel="mega")),
        "torus SOCP": lambda: sprob.solve_jit(p_ex),
        "custom-cone golden LP f64": lambda: tt.solve_jit(
            *golden, tt.ConeLayout([tt.custom(3, lambda b: torch.clamp(
                b, min=0.0), grouped=False)]), p_gold),
        "R+ golden LP f64": lambda: tt.solve_jit(
            *golden, tt.ConeLayout([tt.rpos(3)]), p_gold),
    }, kernels)
    cnt26 = count(runs26)
    tol26 = 50 * p26.eps_acc  # the example's own limits
    worst26 = [0.0, 0.0, 0.0]
    for i, r in enumerate(kept["jacobi"]):
        x = r.x.double().cpu().numpy()
        xm = packed_matrix(x[:sn26], k26)
        xm[np.triu_indices(k26, 1)] /= np.sqrt(2.0)  # scaled-vec
        xm[np.tril_indices(k26, -1)] /= np.sqrt(2.0)
        diag_err = float(np.abs(np.diag(xm) - 1.0).max())
        eig_min = float(np.linalg.eigvalsh(xm).min())
        t_err = abs(x[sn26] - float(np.linalg.norm(xm - covs[i])))
        worst26 = [max(a, b) for a, b in zip(worst26,
                                             (diag_err, -eig_min, t_err))]
        check(r.converged and diag_err < tol26 and eig_min > -tol26
              and t_err < 10 * tol26,
              f"nearest correlation {i}: status {r.status}, |diag - 1| "
              f"{diag_err:.1e}, lambda_min {eig_min:.1e}, |t - ||X - S||| "
              f"{t_err:.1e} (limit {tol26:.0e})")
    r_eigh = kept["eigh"][0]
    dx = float((kept["jacobi"][0].x - r_eigh.x).abs().max())
    check(r_eigh.converged and dx <= 1e-3,
          f"nearest correlation 0: eigh status {r_eigh.status}, x differs "
          f"from jacobi's by {dx:.2e}")
    iters26 = [r.iters for r in kept["jacobi"]]

    check(ref["traj_viol"] <= 1e-3, f"SLSQP's trajectory violates its "
          f"constraints by {ref['traj_viol']:.1e}")
    r_q, wall_q, cnt_q, _ = runs26["trajectory QCQP, megakernel"]
    n_q = a_traj.shape[1]
    sol = r_q.x.double().cpu().numpy()[:n_q]
    obj_q = float(0.5 * sol @ p_traj[0] @ sol)
    viol_q = float(np.abs(a_traj @ sol - b_traj).max())
    acc_q = float(np.sqrt(max(sol @ p_traj[i] @ sol
                              for i in range(1, len(p_traj)))))
    check(r_q.converged and viol_q < 5e-3 and acc_q <= traj[1] * 1.02
          and rel(obj_q, ref["traj"]) <= 5e-3,
          f"trajectory QCQP: status {r_q.status}, equality violation "
          f"{viol_q:.1e}, max |a| {acc_q:.2f} (cap {traj[1]}), objective "
          f"{obj_q:.4f} vs SLSQP's {ref['traj']:.4f}")
    r_s, wall_s, cnt_s, _ = runs26["torus SOCP"]
    sol = r_s.x.double().cpu().numpy()
    obj_s = float(sol[2 * l_t:3 * l_t].sum())
    vol = float(vlen @ sol[:l_t])
    budget = float(vlen.sum() * 0.2)
    eq_s = float(np.abs(a_t @ sol - b_t).max())
    check(r_s.converged and sol[:l_t].min() > -5e-3
          and sol[:l_t].max() < 1.005 and vol <= budget * 1.01
          and eq_s < 5e-3 and rel(obj_s, ref["torus"]) <= 5e-3,
          f"torus SOCP: status {r_s.status}, x in [{sol[:l_t].min():.2e}, "
          f"{sol[:l_t].max():.4f}], volume {vol:.3f} <= {budget:.3f}, "
          f"equality violation {eq_s:.1e}, objective {obj_s:.4f} vs the "
          f"f64 reference {ref['torus']:.4f}")
    r_c = runs26["custom-cone golden LP f64"][0]
    r_r = runs26["R+ golden LP f64"][0]
    check(r_c.converged and r_c.iters == r_r.iters
          and torch.equal(r_c.x, r_r.x),
          f"custom-cone LP: {r_c.iters} iterations (R+ {r_r.iters}), x "
          f"bitwise {torch.equal(r_c.x, r_r.x)}")

    def engine(cnt):
        return "megakernel" if cnt["megakernel"] else "pdhg host loop"

    print(f"phase 26 nearest correlation {n_cov} x k={k26} "
          f"(examples/nearestcorr_batch_sdp.py, one by one, jacobi): all "
          f"CONVERGED in {min(iters26)}-{max(iters26)} iterations, "
          f"{runs26[f'nearest correlation {n_cov} x k={k26}, jacobi'][1]:.3f}"
          f" s, worst |diag - 1| {worst26[0]:.1e}, lambda_min "
          f">= {-worst26[1]:.1e}, |t - ||X - S||_F| {worst26[2]:.1e}; "
          f"instance 0 with eigh {r_eigh.iters} iterations, x within "
          f"{dx:.1e} of jacobi's; trajectory QCQP (t_cap {traj[0]}, a_cap "
          f"{traj[1]}, A {qprob.shape[0]}x{qprob.shape[1]}) on the "
          f"{engine(cnt_q)}: {r_q.iters} iterations, {wall_q:.3f} s, "
          f"objective {obj_q:.4f} (SLSQP {ref['traj']:.4f}); torus SOCP "
          f"({torus[0]}x{torus[1]}, A {sprob.shape[0]}x{sprob.shape[1]}) on "
          f"the {engine(cnt_s)}: {r_s.iters} iterations, {wall_s:.3f} s, "
          f"objective {obj_s:.4f} (f64 {ref['torus']:.4f}); custom-cone "
          f"golden LP f64 {r_c.iters} iterations, bitwise its R+ twin; "
          f"launches {cnt26}", flush=True)

    check(counts["psd_jacobi"] > 0, "phases 24-26 launched psd_jacobi no "
          "time")
    # the row of the first shape: the nearest-correlation solves' launch
    main_row = rows23[(shapes23[0][0], shapes23[0][1], f32)]
    bound = main_row["bound"]
    record = {"name": "psd_jacobi", "route": "cuda",
              "source": "totsu_tpu_torch/csrc/psd_jacobi.cu",
              "replaces": "totsu_tpu/ops/jacobi.py:102",
              "launches": counts["psd_jacobi"],
              "max_abs_err": max(r["err"] for r in rows23.values()),
              "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
              "bound_ms": bound[0], "bound_by": bound[1],
              "library_ms": main_row["lib_ms"],
              "library_wall_ms": main_row["lib_wall"],
              "shape": list(shapes23[0])}
    return counts, record


def stop(proc):
    """Kill a child process that is still running, and reap it."""
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    import totsu_tpu_torch as tt
    from totsu_tpu_torch import interop
    from totsu_tpu_torch.ops.kernels import _build
    from totsu_tpu_torch.ops.kernels import cone_proj as cp
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj
    # the f64 references of phases 4 and 24-26 (HiGHS, the SDP, SOCP and
    # QCQP solves), on the CPU in a child process from the start (about
    # three minutes; it sees no card), stopped on any exit. It runs on two
    # cores of its own and this process on the others, so that the host
    # loops timed in phases 2-22 share no core with it
    cores = sorted(os.sched_getaffinity(0))
    ref_cores = cores[-2:] if len(cores) >= 6 else None
    child = start_cpu_references(cores=ref_cores, **REF_KW)
    atexit.register(stop, child)
    if ref_cores:
        os.sched_setaffinity(0, cores[:-2])
        torch.set_num_threads(min(torch.get_num_threads(), len(cores) - 2))
    ref_cache = {}

    def refs():
        if not ref_cache:
            out, err = child.communicate(timeout=900)
            check(child.returncode == 0, f"the CPU references failed: "
                  f"{err}")
            ref_cache.update(json.loads(out.strip().splitlines()[-1]))
        return ref_cache

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"setup: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}; card: {smi}; cores: "
          f"{sorted(os.sched_getaffinity(0))} (torch threads "
          f"{torch.get_num_threads()}), the CPU references' child "
          f"{ref_cores or 'shares them'}", flush=True)
    kernels = {"dual_matvec": dm, "megakernel": mk, "cone_proj": cp,
               "psd_jacobi": pj}

    # ---- phase 1: build every kernel from the sources in the checkout,
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    _build.build(kernels)
    build_s = time.perf_counter() - t0
    print("phase 1 build: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in _build.build_seconds.items())
        + f"; wall {build_s:.2f} s", flush=True)
    for name in kernels:
        print_ptxas(name, _build.library_path(name))

    # ---- phase 2: dual_matvec against its plain version
    # error bound: max |kernel - plain| <= rtol * max |plain| (f32 sums run
    # in another order; bf16 storage is held against the f32 products of
    # the rounded matrix, which is what the plain version computes)
    rtols = {torch.float32: 2e-4, torch.bfloat16: 2e-4,
             torch.float64: 1e-12}
    dm_err = {}
    rng = np.random.default_rng(0)
    # the main path's first shape, three small ones, and the kernel's edge
    # cases: n not a multiple of the 16-byte vector (rows start unaligned,
    # one element per load), m below one row group's 8 rows, m = 1, n = 1;
    # each A also at a base one element past a 16-byte boundary
    dm_shapes = [(4000, 1000), (400, 100), (173, 77), (8, 128), (300, 1001),
                 (500, 3042), (5, 1001), (1, 1000), (1000, 1), (1, 1)]
    for (m, n) in dm_shapes:
        a64 = torch.from_numpy(rng.normal(size=(m, n))).to(dev)
        u64 = torch.from_numpy(rng.normal(size=n)).to(dev)
        v64 = torch.from_numpy(rng.normal(size=m)).to(dev)
        for dt, rtol in rtols.items():
            acc = dm.acc_dtype(dt)
            u, v = u64.to(acc), v64.to(acc)
            for off in (0, 1):
                a = torch.empty(m * n + off, dtype=dt, device=dev)[off:]
                a = a.view(m, n).copy_(a64)
                p, q = dm.dual_matvec_cuda(a, u, v)
                pp, qp = dm.dual_matvec_plain(a, u, v)
                torch.cuda.synchronize()
                err = max(float((p - pp).abs().max()),
                          float((q - qp).abs().max()))
                scale = max(float(pp.abs().max()), float(qp.abs().max()))
                check(err <= rtol * scale,
                      f"dual_matvec {dt} ({m}, {n}) offset {off}: max err "
                      f"{err:.3e} > {rtol:g} * {scale:.3e}")
                key = (m, n, str(dt))
                dm_err[key] = max(err, dm_err.get(key, 0.0))
    a = torch.from_numpy(rng.normal(size=(4000, 1000))).to(dev, torch.float32)
    u = torch.from_numpy(rng.normal(size=1000)).to(dev, torch.float32)
    v = torch.from_numpy(rng.normal(size=4000)).to(dev, torch.float32)
    times = {}
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        ad = a.to(dt).contiguous()
        ud, vd = u.to(dm.acc_dtype(dt)), v.to(dm.acc_dtype(dt))

        def kern():
            return dm.dual_matvec_cuda(ad, ud, vd)

        def plain():
            return dm.dual_matvec_plain(ad, ud, vd)

        # plain, kernel, kernel, plain: one card, in turns
        p1, k1, k2, p2 = (loop_ms(f) for f in (plain, kern, kern, plain))
        times[str(dt)] = (statistics.median([k1, k2]),
                          statistics.median([p1, p2]),
                          device_ms(kern), device_ms(plain))
    # the library call: cuBLAS's two GEMVs on the same f32 inputs
    dm_library_ms = loop_ms(lambda: (torch.mv(a, u), torch.mv(a.t(), v)))
    dm_bound = bound_ms(4 * 4000 * 1000 + 4 * 2 * (4000 + 1000),
                        4 * 4000 * 1000)

    dm_rand = dm_times(dm, a, u, v)

    print("phase 2 dual_matvec vs plain: ok at "
          + " ".join(f"({m},{n})" for m, n in dm_shapes)
          + " x f32/bf16/f64 x aligned/unaligned base; max err at "
          "(4000,1000) "
          + ", ".join(f"{k.split('.')[-1]} {dm_err[(4000, 1000, k)]:.3e}"
                      for k in times)
          + "; ms per call kernel/plain at (4000,1000) [device ms "
          "kernel/plain] "
          + ", ".join(f"{k.split('.')[-1]} {t[0]:.4f}/{t[1]:.4f} "
                      f"[{fmt_ms(t[2])}/{fmt_ms(t[3])}]"
                      for k, t in times.items())
          + f"; two torch.mv {dm_library_ms:.4f} ms; bound f32 "
          f"{dm_bound[0]:.4f} ms ({dm_bound[1]})", flush=True)
    print("  " + fmt_dm_times("dual_matvec, phase 2's random A 4000x1000 "
                              "f32", dm_rand), flush=True)

    # ---- phase 2b: the blocked exp/pow projection against its plain
    # version: 2000 exp and 2000 pow blocks (500 at each alpha), primal
    # and dual, f32 and f64. Error per block relative to the block's norm
    # (a projection is positively homogeneous; the scales run 1e-12 to
    # 1e12 apart). The two versions do the same arithmetic but round
    # differently (the kernel contracts multiplies and adds into FMAs),
    # and the root finders amplify that: near the pow root's |z0| endpoint
    # an r-error of eps becomes a y-error of about sqrt(eps). Measured on
    # an H100 for these inputs: 2.2e-7 (f32) and 2.1e-12 (f64); the
    # bounds leave a factor of about 100
    cp_tol = {torch.float32: 2e-5, torch.float64: 2e-10}
    rng = np.random.default_rng(1)
    exp_np = cone_blocks("exp", 2000, rng)
    pow_np = np.concatenate([cone_blocks("pow", 500, rng, al)
                             for al in (0.1, 0.3, 0.5, 0.9)])
    alpha_np = np.repeat([0.1, 0.3, 0.5, 0.9], 500)
    cp_err = {}
    cp_times = {}
    cp_latency = cone_eval_latency(cp, dev)
    for dt in (torch.float32, torch.float64):
        for kind, blk in (("exp", exp_np), ("pow", pow_np)):
            xb = torch.tensor(blk, dtype=dt, device=dev)
            al = (torch.tensor(alpha_np, dtype=dt, device=dev)
                  if kind == "pow" else 0.0)
            nrm = torch.linalg.vector_norm(xb.double(), dim=1).clamp(
                min=1e-300)
            for dual in (False, True):
                got = cp.cone_proj_cuda(xb, kind, al, dual)
                again = cp.cone_proj_cuda(xb, kind, al, dual)
                want = cp.cone_proj_plain(xb, kind, al, dual)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"cone_proj {kind} {dt} dual={dual}: non-finite")
                rel = float(((got - want).double().abs().amax(1) / nrm).max())
                check(rel <= cp_tol[dt],
                      f"cone_proj {kind} {dt} dual={dual}: max error "
                      f"{rel:.3e} of the block norm > {cp_tol[dt]:g}")
                check(torch.equal(got, again), f"cone_proj {kind} {dt} "
                      f"dual={dual}: a second call differs")
                cp_err[(kind, str(dt), dual)] = rel

            def kern():
                return cp.cone_proj_cuda(xb, kind, al, False)
            k1 = loop_ms(kern)
            p1 = loop_ms(lambda: cp.cone_proj_plain(xb, kind, al, False),
                         calls=5, warmup=1)
            cp_times[(kind, str(dt))] = (k1, p1, stream_ms(kern),
                                         cone_proj_floor(cp, xb, kind, al,
                                                         False, cp_latency))
    pl2b = cp.device_plan(2000, "exp", torch.float32, dev)
    print("phase 2b cone_proj vs plain (2000 exp, 2000 pow blocks at "
          "alpha 0.1/0.3/0.5/0.9, scales 1e-6..1e6; plan "
          f"{pl2b.describe()}): max error / block "
          "norm " + ", ".join(
              f"{k} {d.split('.')[-1]} {'dual' if du else 'primal'} "
              f"{e:.2e}" for (k, d, du), e in cp_err.items())
          + f" (bounds f32 {cp_tol[torch.float32]:g}, f64 "
          f"{cp_tol[torch.float64]:g}); a second call bitwise equal; ms "
          "per call kernel/plain back to back [kernel device ms by events] "
          + ", ".join(f"{k} {d.split('.')[-1]} {t[0]:.4f}/{t[1]:.2f} "
                      f"[{fmt_ms(t[2])}]"
                      for (k, d), t in cp_times.items()), flush=True)
    print("  cone_proj latency: clocks and us per root-function "
          "evaluation " + ", ".join(
              f"{k} {d.split('.')[-1]} {c:.0f}/{1e3 * ms:.4f}"
              for (k, d), (c, ms) in cp_latency.items())
          + "; primal chains (lane model / serial reference) and "
          "model-derived latency floors in us " + ", ".join(
              f"{k} {d.split('.')[-1]} {t[3][0]}/{t[3][1]} "
              f"{1e3 * t[3][2]:.4f}" for (k, d), t in cp_times.items()),
          flush=True)

    # ---- phase 3: the golden LP in f64 on the card
    c, a, b = interop.problem_from_numpy(
        [-1.0, 0.0], [[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]],
        [6.0, 6.0, 1.0], device=dev, dtype=torch.float64)
    res = tt.solve(c, a, b, tt.ConeLayout([tt.rpos(3)]),
                   tt.SolverParam(max_iter=100_000))
    x = res.x.cpu().numpy()
    golden = np.array([1.9999994251590176, 2.0000004472430635])
    check(res.iters == 160, f"golden LP took {res.iters} iterations, not 160")
    check(np.abs(x - golden).max() <= 1e-8, f"golden LP x = {x.tolist()}")
    print(f"phase 3 golden LP f64: {res.iters} iterations, x = "
          f"{x.tolist()}, max |x - golden| {np.abs(x - golden).max():.3e}",
          flush=True)

    # ---- the main path, one solve per path through the entry points a
    # user calls: the full-width LP and the full-width exp-cone logistic
    # regression on the host loop; the megakernel solves of the n=100 LP,
    # the QP, the GP and the growth portfolio. Every launch count is set
    # to 0 just before each path and read just after it.
    p_full = tt.SolverParam(accel="halpern", normalize=True, equil_iters=10,
                            check_period=20, eps_acc=1e-3, max_iter=200_000)
    p_mega = dataclasses.replace(p_full, kernel="mega")
    # the GP and the growth portfolio at eps_acc 1e-4: at 1e-3 their
    # epigraph variables and budgets sit loose enough (the growth
    # portfolio's simplex sum at 1.004 on the CPU) that the comparison
    # with SLSQP would measure the tolerance, not the solve
    p_tight = dataclasses.replace(p_full, eps_acc=1e-4)
    p_tight_mega = dataclasses.replace(p_tight, kernel="mega")
    f32 = torch.float32
    c1, a1, b1 = make_lp(1000)
    lp_cone = tt.ConeLayout([tt.rpos(a1.shape[0])])
    c1t, a1t, b1t = interop.problem_from_numpy(c1, a1, b1, device=dev,
                                               dtype=f32)
    c2, a2, b2 = make_lp(100)
    c2t, a2t, b2t = interop.problem_from_numpy(c2, a2, b2, device=dev,
                                               dtype=f32)
    lp2_cone = tt.ConeLayout([tt.rpos(a2.shape[0])])
    qprob = tt.problems.qp(*[torch.from_numpy(x).to(dev)
                             for x in make_qp(50)])
    lr_m, lr_n, lam = 1000, 20, 0.1
    lr_x, lr_y, c4, a4, b4, lr_spec = make_logreg(lr_m, lr_n, lam)
    c4t, a4t, b4t = interop.problem_from_numpy(c4, a4, b4, device=dev,
                                               dtype=f32)
    lr_cone = cone(tt, lr_spec)
    gp_c, gp_a = make_gp_terms()
    gprob, gmeta = tt.problems.gp(gp_c, gp_a, device=dev, dtype=f32)
    h_budget = -2.0
    returns, c6, a6, b6, gr_spec, gr_root = make_growth(64, 50, h_budget)
    c6t, a6t, b6t = interop.problem_from_numpy(c6, a6, b6, device=dev,
                                               dtype=f32)
    gr_cone = cone(tt, gr_spec)

    recorded = []  # the megakernel's inputs, to hold it against its plain
    real_solve_mega = mk.solve_mega

    def recording_solve_mega(*args, **kwargs):
        recorded.append((args, kwargs))
        return real_solve_mega(*args, **kwargs)

    cp_recorded = {}  # the last cone_proj input of each kind (the inputs
    real_cone_proj = cp.cone_proj_cuda  # are fresh tensors, never written)

    def recording_cone_proj(blocks, kind, alpha=0.0, dual=False):
        cp_recorded[dual] = (blocks, kind, alpha)
        return real_cone_proj(blocks, kind, alpha, dual)

    dm_recorded = {}  # the last dual_matvec input for each shape of A
    real_dual_matvec = dm.dual_matvec_cuda

    def recording_dual_matvec(a, u, v):
        dm_recorded[tuple(a.shape)] = (a, u.clone(), v.clone())
        return real_dual_matvec(a, u, v)

    paths = {
        "LP n=1000, host loop":
            lambda: tt.solve(c1t, a1t, b1t, lp_cone, p_full),
        "LP n=100, megakernel":
            lambda: tt.solve(c2t, a2t, b2t, lp2_cone, p_mega),
        "QP n=50, megakernel": lambda: qprob.solve(p_mega),
        "logistic regression m=1000 n=20, host loop":
            lambda: tt.solve(c4t, a4t, b4t, lr_cone, p_full),
        "GP n=100, megakernel": lambda: gprob.solve(p_tight_mega),
        "growth portfolio S=64 n=50, megakernel":
            lambda: tt.solve(c6t, a6t, b6t, gr_cone, p_tight_mega),
        "LP n=1000, megakernel":
            lambda: tt.solve(c1t, a1t, b1t, lp_cone, p_mega),
    }
    mk.solve_mega = recording_solve_mega
    cp.cone_proj_cuda = recording_cone_proj
    dm.dual_matvec_cuda = recording_dual_matvec
    try:
        runs = drive(paths, kernels)
    finally:
        mk.solve_mega = real_solve_mega
        cp.cone_proj_cuda = real_cone_proj
        dm.dual_matvec_cuda = real_dual_matvec
    main_counts = {k: sum(r[2][k] for r in runs.values()) for k in kernels}
    for name in ("dual_matvec", "megakernel", "cone_proj"):
        check(main_counts[name] > 0, f"the main path launched {name} no "
              "time")
    r_full, wall_full, cnt_full, _ = runs["LP n=1000, host loop"]
    r_lp_m, wall_lp_m, cnt_lp_m, _ = runs["LP n=100, megakernel"]
    r_qp_m, wall_qp_m, cnt_qp_m, _ = runs["QP n=50, megakernel"]
    r_lr, wall_lr, cnt_lr, _ = runs[
        "logistic regression m=1000 n=20, host loop"]
    r_gp_m, wall_gp_m, cnt_gp_m, _ = runs["GP n=100, megakernel"]
    r_gr_m, wall_gr_m, cnt_gr_m, _ = runs[
        "growth portfolio S=64 n=50, megakernel"]
    r_full_m, wall_full_m, cnt_full_m, _ = runs["LP n=1000, megakernel"]
    for what, cnt in (("LP n=100", cnt_lp_m), ("QP n=50", cnt_qp_m),
                      ("GP", cnt_gp_m), ("growth portfolio", cnt_gr_m),
                      ("LP n=1000", cnt_full_m)):
        check(cnt["megakernel"] == 1,
              f"{what}: {cnt['megakernel']} megakernel launches per solve")
    # the launch plan of every megakernel solve (cached: the plan the
    # solve ran)
    mega_names = ["LP n=100", "QP n=50", "GP n=100", "growth portfolio",
                  "LP n=1000"]
    check(len(recorded) == len(mega_names),
          f"{len(recorded)} megakernel solves recorded")
    plans = {}
    for what, (args, _) in zip(mega_names, recorded):
        m_, n_ = args[0].shape
        plans[what] = mk.device_plan(m_, n_, args[9], dev)[0]
        print(f"  megakernel plan, {what} (A {m_}x{n_}): "
              f"{plans[what].describe()}", flush=True)

    # ---- phase 4: full-width LP checks, against HiGHS (solved in the
    # child process)
    check(r_full.converged, f"n=1000 LP status {r_full.status}")
    obj = float(np.dot(c1.astype(np.float64),
                       r_full.x.double().cpu().numpy()))
    hi = refs()["lp"]
    highs_s = hi["seconds"]
    check(hi["status"] == 0, f"HiGHS status {hi['status']}: "
          f"{hi['message']}")
    rel = abs(obj - hi["fun"]) / max(1.0, abs(hi["fun"]))
    check(rel <= 5e-3, f"n=1000 objective {obj} vs HiGHS {hi['fun']} "
          f"(rel {rel:.3e})")
    dm_full = cnt_full["dual_matvec"]
    check(dm_full >= 2 * r_full.iters,
          f"{dm_full} dual_matvec launches < 2 x {r_full.iters} iterations")
    r_again = tt.solve(c1t, a1t, b1t, lp_cone, p_full)
    check(r_again.iters == r_full.iters,
          f"repeat solve took {r_again.iters} iterations, not "
          f"{r_full.iters}")
    check(torch.equal(r_again.x, r_full.x), "repeat solve: x differs")
    print(f"phase 4 n=1000 LP (A 4000x1000 f32): CONVERGED in "
          f"{r_full.iters} iterations, {wall_full:.3f} s, "
          f"{r_full.iters / wall_full:.1f} iterations/s, "
          f"{dm_full} dual_matvec launches; objective {obj:.6f} vs HiGHS "
          f"{hi['fun']:.6f} (rel {rel:.2e}, HiGHS {highs_s:.2f} s); repeat "
          "solve: same iterations, bitwise-equal x", flush=True)

    # ---- phase 4b: the same LP through kernel='mega' (A 16 MB, sliced
    # over the SMs' shared memory): objective within 5e-3 of phase 4's
    # HiGHS value. x: at eps_acc 1e-3 both f32 solves sit about 3.6e-2
    # (max-norm, relative) from HiGHS's optimal vertex, and the two stop
    # on different iterations (the sums run in other orders), so they
    # agree to a few 1e-3, not to 1e-3 (2.5e-3 measured on an H100): x
    # within 1e-2 relative of phase 4's host-loop x, and no more than
    # 1.25 times as far from HiGHS's x as the host loop's
    check(r_full_m.converged, f"n=1000 LP megakernel status "
          f"{r_full_m.status}")
    xm = r_full_m.x.double().cpu()
    xl = r_full.x.double().cpu()
    full_rel_x = float((xm - xl).abs().max() / xl.abs().max().clamp(min=1.0))
    check(full_rel_x <= 1e-2, f"n=1000 LP megakernel: x differs from the "
          f"host loop by {full_rel_x:.3e} relative")
    xh = torch.from_numpy(np.asarray(hi["x"], np.float64))
    scale_h = float(xh.abs().max().clamp(min=1.0))
    dist_m = float((xm - xh).abs().max()) / scale_h
    dist_l = float((xl - xh).abs().max()) / scale_h
    check(dist_m <= 1.25 * dist_l, f"n=1000 LP megakernel: x {dist_m:.3e} "
          f"from HiGHS's, the host loop's {dist_l:.3e}")
    obj_m = float(np.dot(c1.astype(np.float64), xm.numpy()))
    rel_m = abs(obj_m - hi["fun"]) / max(1.0, abs(hi["fun"]))
    check(rel_m <= 5e-3, f"n=1000 LP megakernel objective {obj_m} vs HiGHS "
          f"{hi['fun']} (rel {rel_m:.3e})")
    print(f"phase 4b n=1000 LP megakernel ({plans['LP n=1000'].describe()}):"
          f" CONVERGED in {r_full_m.iters} iterations, {wall_full_m:.3f} s "
          f"({1e3 * wall_full_m / r_full_m.iters:.4f} ms per iteration, host "
          f"loop {1e3 * wall_full / r_full.iters:.4f}); x rel diff to the "
          f"host loop {full_rel_x:.2e}; x from HiGHS's {dist_m:.2e} (host "
          f"loop {dist_l:.2e}); objective {obj_m:.6f} vs HiGHS "
          f"{hi['fun']:.6f} (rel {rel_m:.2e}); 1 launch", flush=True)

    def rel_x(rm, rx, k):
        xm, xx = rm.x[:k].double().cpu(), rx.x[:k].double().cpu()
        return float((xm - xx).abs().max() / xx.abs().max().clamp(min=1.0))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- phase 5: megakernel solves against the host loop
    r_lp_x, wall_lp_x = timed(lambda: tt.solve(c2t, a2t, b2t, lp2_cone,
                                               p_full))
    r_qp_x, wall_qp_x = timed(lambda: qprob.solve(p_full))
    rels = []
    for what, rm, rx, k in (("LP n=100", r_lp_m, r_lp_x, 100),
                            ("QP n=50", r_qp_m, r_qp_x, 50)):
        check(rm.converged and rx.converged,
              f"{what}: status mega {rm.status}, loop {rx.status}")
        rels.append(rel_x(rm, rx, k))
        check(rels[-1] <= 1e-3, f"{what}: x differs by {rels[-1]:.3e} "
              "relative")
    print(f"phase 5 megakernel vs host loop: LP n=100 {r_lp_m.iters}/"
          f"{r_lp_x.iters} iterations, {wall_lp_m:.3f}/{wall_lp_x:.3f} s; "
          f"QP n=50 {r_qp_m.iters}/{r_qp_x.iters} iterations, "
          f"{wall_qp_m:.3f}/{wall_qp_x:.3f} s; x rel diff "
          f"{rels[0]:.2e}, {rels[1]:.2e}; 1 launch per mega solve",
          flush=True)

    # ---- phase 6: the full-width exp-cone logistic regression (A 7040 x
    # 3040 f32, 85.6 MB, beyond the 50 MB L2; R+(1040) and 2000 exp
    # blocks) on the host loop: objective against L-BFGS-B within 5e-3
    # relative (eps_acc 1e-3 lets the residuals and the gap sit near
    # 1e-3), two cone_proj launches per iteration at least (dual and
    # primal), a repeat solve bitwise equal
    check(r_lr.converged, f"logistic regression status {r_lr.status}")
    w = r_lr.x[:lr_n].double().cpu().numpy()
    lr_obj = logreg_objective(lr_x, lr_y, w, lam)
    t0 = time.perf_counter()
    lr_ref = logreg_reference(lr_x, lr_y, lam)
    lbfgs_s = time.perf_counter() - t0
    lr_rel = abs(lr_obj - lr_ref) / abs(lr_ref)
    check(lr_rel <= 5e-3, f"logistic regression objective {lr_obj} vs "
          f"L-BFGS-B {lr_ref} (rel {lr_rel:.3e})")
    check(cnt_lr["cone_proj"] >= 2 * r_lr.iters,
          f"{cnt_lr['cone_proj']} cone_proj launches < 2 x {r_lr.iters} "
          "iterations")
    r_lr2 = tt.solve(c4t, a4t, b4t, lr_cone, p_full)
    check(r_lr2.iters == r_lr.iters,
          f"logistic regression repeat: {r_lr2.iters} iterations, not "
          f"{r_lr.iters}")
    check(torch.equal(r_lr2.x, r_lr.x), "logistic regression repeat: x "
          "differs")
    print(f"phase 6 logistic regression m=1000 n=20 (A {a4.shape[0]}x"
          f"{a4.shape[1]} f32, 2000 exp blocks), host loop: CONVERGED in "
          f"{r_lr.iters} iterations, {wall_lr:.3f} s, "
          f"{r_lr.iters / wall_lr:.1f} iterations/s; launches "
          f"{cnt_lr} ({cnt_lr['cone_proj'] / r_lr.iters:.2f} cone_proj and "
          f"{cnt_lr['dual_matvec'] / r_lr.iters:.2f} dual_matvec per "
          f"iteration); objective {lr_obj:.6f} vs L-BFGS-B {lr_ref:.6f} "
          f"(rel {lr_rel:.2e}, {lbfgs_s:.2f} s); repeat solve: same "
          "iterations, bitwise-equal x", flush=True)

    # ---- phase 7: the GP (n = 100, 600 exp blocks, A 2001 x 701) on the
    # megakernel against the host loop, and its objective against SLSQP
    # on the log-form NLP (5e-3 relative); the objective and the
    # constraints are evaluated at x = exp(y) of the solve
    r_gp_x, wall_gp_x = timed(lambda: gprob.solve(p_tight))
    gn = gmeta["n"]
    check(r_gp_m.converged and r_gp_x.converged,
          f"GP: status mega {r_gp_m.status}, loop {r_gp_x.status}")
    gp_rel_x = rel_x(r_gp_m, r_gp_x, gn)
    check(gp_rel_x <= 1e-3, f"GP: x differs by {gp_rel_x:.3e} relative")
    t0 = time.perf_counter()
    gp_ref = gp_reference(gp_c, gp_a)
    slsqp_s = time.perf_counter() - t0
    xg = np.exp(r_gp_m.x[:gn].double().cpu().numpy())
    posy = [float(np.sum(ci * np.prod(xg[None, :] ** ai, axis=1)))
            for ci, ai in zip(gp_c, gp_a)]
    gp_rel = abs(posy[0] - gp_ref) / gp_ref
    check(gp_rel <= 5e-3, f"GP objective {posy[0]} vs SLSQP {gp_ref} "
          f"(rel {gp_rel:.3e})")
    check(max(posy[1:]) <= 1.01, f"GP constraint at {max(posy[1:]):.4f}")
    # a repeat of the megakernel solve on the same card: bitwise equal
    # (fixed sum orders in and across CTAs, no atomics in the sums)
    r_gp_m2, wall_gp_m2 = timed(lambda: gprob.solve(p_tight_mega))
    check(r_gp_m2.iters == r_gp_m.iters,
          f"GP megakernel repeat: {r_gp_m2.iters} iterations, not "
          f"{r_gp_m.iters}")
    check(torch.equal(r_gp_m2.x, r_gp_m.x), "GP megakernel repeat: x "
          "differs")
    print(f"phase 7 GP n=100 (A {gprob.shape[0]}x{gprob.shape[1]} f32, 600 "
          f"exp blocks): megakernel/host loop {r_gp_m.iters}/"
          f"{r_gp_x.iters} iterations, {wall_gp_m:.3f}/{wall_gp_x:.3f} s; "
          f"x rel diff {gp_rel_x:.2e}; objective {posy[0]:.6f} vs SLSQP "
          f"{gp_ref:.6f} (rel {gp_rel:.2e}, {slsqp_s:.2f} s), max f_i "
          f"{max(posy[1:]):.6f}; 1 launch per mega solve; megakernel "
          f"repeat ({wall_gp_m2:.3f} s): same iterations, bitwise-equal x",
          flush=True)

    # ---- phase 8: the growth portfolio (S = 64, n = 50: 63 pow(1/2) and
    # 50 exp blocks) on the megakernel against the host loop, and against
    # the example's SLSQP oracle (5e-3 relative)
    r_gr_x, wall_gr_x = timed(lambda: tt.solve(c6t, a6t, b6t, gr_cone,
                                               p_tight))
    check(r_gr_m.converged and r_gr_x.converged,
          f"growth: status mega {r_gr_m.status}, loop {r_gr_x.status}")
    gr_rel_x = rel_x(r_gr_m, r_gr_x, 50)
    check(gr_rel_x <= 1e-3, f"growth: x differs by {gr_rel_x:.3e} relative")
    gr_ref = growth_reference(returns, h_budget)
    growth = float(r_gr_m.x[gr_root])
    gr_rel = abs(growth - gr_ref) / gr_ref
    check(gr_rel <= 5e-3, f"growth {growth} vs SLSQP {gr_ref} "
          f"(rel {gr_rel:.3e})")
    alloc = r_gr_m.x[:50].double().cpu().numpy()
    check(abs(alloc.sum() - 1.0) <= 1e-2, f"growth: sum x = {alloc.sum()}")
    print(f"phase 8 growth portfolio S=64 n=50 (A {a6.shape[0]}x"
          f"{a6.shape[1]} f32, 63 pow + 50 exp blocks): megakernel/host "
          f"loop {r_gr_m.iters}/{r_gr_x.iters} iterations, "
          f"{wall_gr_m:.3f}/{wall_gr_x:.3f} s; x rel diff {gr_rel_x:.2e}; "
          f"growth {growth:.6f} vs SLSQP {gr_ref:.6f} (rel {gr_rel:.2e}); "
          "1 launch per mega solve", flush=True)

    # ---- phase 9: the megakernel against its plain version (the host
    # loop) on the inputs the main path gave it: the n=100 LP and the GP
    def mega_vs_plain(args, kwargs, plain_reps):
        k_s, out_k = sync_time(lambda: mk.solve_mega_cuda(*args, **kwargs),
                               3)
        p_s, out_p = sync_time(lambda: mk.solve_mega_plain(*args, **kwargs),
                               plain_reps)
        check(out_k[3] == out_p[3] == tt.SolverStatus.CONVERGED,
              f"megakernel status {out_k[3]}, plain {out_p[3]}")
        xk, xp = out_k[0][0] / out_k[0][3], out_p[0][0] / out_p[0][3]
        err = float((xk - xp).abs().max())
        check(err <= 1e-3 * max(1.0, float(xp.abs().max())),
              f"megakernel x/tau differs from plain by {err:.3e}")
        m_, n_ = args[0].shape
        bnd = bound_ms(4 * m_ * n_, 8 * m_ * n_ * out_k[2])
        return out_k[2], out_p[2], k_s, p_s, err, bnd

    mk_lp = mega_vs_plain(*recorded[0], plain_reps=3)
    mk_gp = mega_vs_plain(*recorded[2], plain_reps=1)
    print("phase 9 megakernel vs plain: " + "; ".join(
        f"{what} {r[0]}/{r[1]} iterations, {1e3 * r[2]:.2f}/"
        f"{1e3 * r[3]:.2f} ms, max |x err| {r[4]:.3e}, bound "
        f"{r[5][0]:.4f} ms ({r[5][1]})"
        for what, r in (("n=100 LP inputs", mk_lp), ("GP inputs", mk_gp))),
        flush=True)
    # the same n=100 LP inputs on layouts the plan does not pick for them:
    # one and several CTAs, both modes of the cross-CTA sums, the vectors
    # in scratch (the layout of a wide A); x/tau against the plain
    # version's at phase 9's tolerance
    args, kwargs = recorded[0]
    up = mk.solve_mega_plain(*args, **kwargs)[0]
    xp = up[0] / up[3]
    forced = []
    try:
        for over in ({"grid": 1}, {"grid": 4, "split": True},
                     {"grid": 13}, {"grid": 4, "vec_smem": False}):
            mk.PLAN_OVERRIDES.clear()
            mk.PLAN_OVERRIDES.update(over)
            out = mk.solve_mega_cuda(*args, **kwargs)
            err = float((out[0][0] / out[0][3] - xp).abs().max())
            check(out[3] == tt.SolverStatus.CONVERGED
                  and err <= 1e-3 * max(1.0, float(xp.abs().max())),
                  f"megakernel with plan {over}: status {out[3]}, x/tau "
                  f"differs from plain by {err:.3e}")
            forced.append((over, out[2], err))
    finally:
        mk.PLAN_OVERRIDES.clear()
    print("  megakernel on the n=100 LP inputs with forced plans: "
          + "; ".join(f"{over}: {k_} iterations, max |x err| {e:.3e}"
                      for over, k_, e in forced), flush=True)

    # dual_matvec on the last inputs each host-loop path gave it (the
    # n=1000 LP's A 4000 x 1000 and the logistic regression's 7040 x 3040,
    # both f32 after Ruiz scaling), at phase 2's f32 tolerance; a second
    # call is bitwise equal (the cross-CTA sums run in a fixed order);
    # timed against its plain version and two torch.mv
    dm_main = {}
    for shape, (a_r, u_r, v_r) in sorted(dm_recorded.items()):
        p, q = dm.dual_matvec_cuda(a_r, u_r, v_r)
        p2, q2 = dm.dual_matvec_cuda(a_r, u_r, v_r)
        pp, qp = dm.dual_matvec_plain(a_r, u_r, v_r)
        err = max(float((p - pp).abs().max()), float((q - qp).abs().max()))
        scale = max(float(pp.abs().max()), float(qp.abs().max()))
        rtol = rtols[a_r.dtype]
        check(err <= rtol * scale,
              f"dual_matvec on the main path's {shape} inputs: max err "
              f"{err:.3e} > {rtol:g} * {scale:.3e}")
        check(torch.equal(p, p2) and torch.equal(q, q2),
              f"dual_matvec on the main path's {shape} inputs: a second "
              "call differs")
        dm_main[shape] = (err, dm_times(dm, a_r, u_r, v_r))
    check(tuple(a4.shape) in dm_main, "the logistic regression's "
          "dual_matvec inputs were not recorded")
    print("dual_matvec on the main path's inputs (repeat bitwise equal): "
          + "; ".join(
              f"A {m_}x{n_} {dm_recorded[(m_, n_)][0].dtype}: max abs err "
              f"{r[0]:.3e} (bound "
              f"{rtols[dm_recorded[(m_, n_)][0].dtype]:g} of the largest "
              "output)" for (m_, n_), r in dm_main.items()), flush=True)
    for (m_, n_), r in dm_main.items():
        print("  " + fmt_dm_times(f"dual_matvec, recorded A {m_}x{n_}", r[1]),
              flush=True)

    # cone_proj on the last inputs the logistic regression's host loop
    # gave it (2000 f32 exp blocks, primal and dual): against its plain
    # version at phase 2b's tolerance, a second call bitwise equal; timed
    # back to back and by events behind a sleeping stream
    cp_main = {}
    for dual, (blk, kind, al) in cp_recorded.items():
        got = cp.cone_proj_cuda(blk, kind, al, dual)
        again = cp.cone_proj_cuda(blk, kind, al, dual)
        want = cp.cone_proj_plain(blk, kind, al, dual)
        err = float((got - want).abs().max())
        nrm = torch.linalg.vector_norm(blk.double(), dim=1).clamp(min=1e-300)
        rel = float(((got - want).double().abs().amax(1) / nrm).max())
        check(rel <= cp_tol[blk.dtype],
              f"cone_proj on the main path's inputs: {rel:.3e}")
        check(torch.equal(got, again), "cone_proj on the main path's "
              "inputs: a second call differs")

        def kern():
            return cp.cone_proj_cuda(blk, kind, al, dual)
        k_ms = loop_ms(kern)
        p_ms = loop_ms(lambda: cp.cone_proj_plain(blk, kind, al, dual),
                       calls=5, warmup=1)
        ops = cone_proj_ops(blk, kind, al, dual)
        cp_main[dual] = (err, k_ms, p_ms,
                         bound_ms(2 * blk.numel() * blk.element_size(), ops,
                                  blk.dtype), ops, blk.shape[0],
                         stream_ms(kern),
                         cone_proj_floor(cp, blk, kind, al, dual, cp_latency),
                         cone_proj_trips(blk, kind, al, dual)[0])
    print("cone_proj on the logistic regression's inputs (plan "
          f"{cp.device_plan(blk.shape[0], kind, blk.dtype, dev).describe()}"
          "; a second call bitwise equal): " + "; ".join(
              f"{'dual' if du else 'primal'} {r[5]} blocks: max abs err "
              f"{r[0]:.3e}, {r[1]:.4f}/{r[2]:.2f} ms kernel/plain back to "
              f"back, kernel device {fmt_ms(r[6])} ms by events; "
              f"{r[4]} operations, bound {r[3][0]:.6f} ms ({r[3][1]}); "
              f"reference trips {r[8]}, longest chain {r[7][1]}; lane "
              f"model's chain {r[7][0]}, model-derived latency floor "
              f"{r[7][2]:.6f} ms"
              for du, r in cp_main.items()), flush=True)

    # ---- phase 10: where the host loop's time goes, 200 iterations of
    # each host-loop cell under torch.profiler (kernel rows only)
    p_prof = dataclasses.replace(p_full, max_iter=200)
    for what, fn in (
            ("LP n=1000", lambda: tt.solve_jit(c1t, a1t, b1t, lp_cone,
                                               p_prof)),
            ("logistic regression", lambda: tt.solve_jit(
                c4t, a4t, b4t, lr_cone, p_prof))):
        wall_us, busy_us, nlaunch, top = profile_loop(fn, 200)
        print(f"phase 10 profile {what}, host loop, 200 iterations: "
              f"{wall_us:.1f} us wall and {busy_us:.1f} us device-busy per "
              f"iteration ({100 * busy_us / wall_us:.1f}% busy), "
              f"{nlaunch:.1f} kernel launches per iteration; top kernels "
              "(us per iteration) " + ", ".join(
                  f"{k} {t:.1f}" for k, t in top), flush=True)

    # ---- phases 11-16: the direct engine (Douglas-Rachford on the HSDE,
    # plain and Halpern), the fast profile's routing and accel='restart',
    # each path driven once through solve() with the launch counts set to
    # 0 just before it. The direct engine's cache build (spd_cache: A^T A,
    # then the Newton-Schulz inverse in f32) and its loop are timed
    # inside the solve, the card synchronized around each
    from totsu_tpu_torch.solver import conic as tconic
    from totsu_tpu_torch.solver import direct as tdirect
    p_fast = tt.SolverParam(profile="fast", eps_acc=1e-3, max_iter=200_000)
    p_fast_tight = dataclasses.replace(p_fast, eps_acc=1e-4)
    p_golden = tt.SolverParam(max_iter=100_000, method="direct")
    p_direct = tt.SolverParam(method="direct", accel="halpern",
                              check_period=20, eps_acc=1e-3,
                              max_iter=200_000)
    p_restart = dataclasses.replace(p_full, accel="restart")
    golden_cone = tt.ConeLayout([tt.rpos(3)])
    c3, a3, b3 = make_lp(4000)
    c3t, a3t, b3t = interop.problem_from_numpy(c3, a3, b3, device=dev,
                                               dtype=f32)
    lp3_cone = tt.ConeLayout([tt.rpos(a3.shape[0])])
    slice_paths = {
        "golden LP f64, direct":
            lambda: tt.solve(c, a, b, golden_cone, p_golden),
        "LP n=1000, fast profile":
            lambda: tt.solve(c1t, a1t, b1t, lp_cone, p_fast),
        "LP n=4000, fast profile":
            lambda: tt.solve(c3t, a3t, b3t, lp3_cone, p_fast),
        "logistic regression m=1000 n=20, fast profile":
            lambda: tt.solve(c4t, a4t, b4t, lr_cone, p_fast),
        "GP n=100, fast profile": lambda: gprob.solve(p_fast_tight),
        "growth portfolio S=64 n=50, fast profile":
            lambda: tt.solve(c6t, a6t, b6t, gr_cone, p_fast_tight),
        "LP n=100, fast profile":
            lambda: tt.solve(c2t, a2t, b2t, lp2_cone, p_fast),
        "QP n=50, fast profile": lambda: qprob.solve(p_fast),
        "LP n=100, direct Halpern":
            lambda: tt.solve(c2t, a2t, b2t, lp2_cone, p_direct),
        "QP n=50, direct Halpern": lambda: qprob.solve(p_direct),
        "LP n=100, restart, host loop":
            lambda: tt.solve(c2t, a2t, b2t, lp2_cone, p_restart),
    }
    spans = []
    real_direct = time_calls(tdirect, ("spd_cache", "newton_schulz_inverse",
                                       "_run_halpern_dr", "_run_plain"),
                             spans)
    try:
        slice_runs = drive(slice_paths, kernels, spans)

        def direct_times(sp):
            """(cache build ms, its Newton-Schulz ms and steps, loop ms)"""
            caches = [out for name, _, out in sp if name == "spd_cache"]
            check(len(caches) == 1, f"{len(caches)} cache builds in a solve")
            return (span_ms(sp, "spd_cache"),
                    span_ms(sp, "newton_schulz_inverse"), caches[0].ns_steps,
                    span_ms(sp, "_run_halpern_dr") + span_ms(sp, "_run_plain"))

        def fmt_direct(wall, sp):
            build, ns, steps, loop = direct_times(sp)
            return (f"time to solution {1e3 * wall:.1f} ms: cache build "
                    f"{build:.1f} ms (A^T A {build - ns:.1f} ms, "
                    f"Newton-Schulz {ns:.1f} ms in {steps} steps), loop "
                    f"{loop:.1f} ms")

        def rel_obj(got, want):
            return abs(got - want) / max(1.0, abs(want))

        def objective(cvec, res):
            cv = cvec if isinstance(cvec, np.ndarray) else cvec.cpu().numpy()
            return float(np.dot(cv.astype(np.float64),
                                res.x.double().cpu().numpy()))

        # ---- phase 11: the golden LP in f64 through method='direct' on
        # the card (Cholesky by cuSOLVER): x within 1e-4 of (2, 2) in
        # under 100 iterations, as many as the same call on the CPU
        r11, wall11, cnt11, _ = slice_runs["golden LP f64, direct"]
        x11 = r11.x.cpu().numpy()
        r11_cpu = tt.solve(c.cpu(), a.cpu(), b.cpu(), golden_cone, p_golden)
        check(np.abs(x11 - 2.0).max() <= 1e-4 and r11.iters < 100,
              f"golden LP direct: x = {x11.tolist()}, {r11.iters} iterations")
        check(r11.iters == r11_cpu.iters, f"golden LP direct: {r11.iters} "
              f"iterations on the card, {r11_cpu.iters} on the CPU")
        print(f"phase 11 golden LP f64, method='direct': {r11.iters} "
              f"iterations (CPU {r11_cpu.iters}), x = {x11.tolist()}, "
              f"{1e3 * wall11:.1f} ms, launches {cnt11}", flush=True)

        # ---- phase 12: the n=1000 benchmark LP under profile='fast' (the
        # reference bench's headline): the direct engine with Halpern,
        # objective within 5e-3 of HiGHS; a repeat is bitwise equal
        p12 = tconic._resolve_fast_profile(p_fast, tt.DenseOp(a1t), lp_cone)
        check((p12.method, p12.accel, p12.check_period)
              == ("direct", "halpern", 20), f"n=1000 LP fast profile: {p12}")
        r12, wall12, cnt12, sp12 = slice_runs["LP n=1000, fast profile"]
        check(r12.converged, f"n=1000 LP fast profile status {r12.status}")
        obj12 = objective(c1, r12)
        rel12 = rel_obj(obj12, hi["fun"])
        check(rel12 <= 5e-3, f"n=1000 LP fast profile objective {obj12} vs "
              f"HiGHS {hi['fun']} (rel {rel12:.3e})")
        spans.clear()
        r12b, wall12b = timed(lambda: tt.solve(c1t, a1t, b1t, lp_cone,
                                               p_fast))
        sp12b = list(spans)
        check(r12b.iters == r12.iters and torch.equal(r12b.x, r12.x),
              f"n=1000 LP fast profile repeat: {r12b.iters} iterations "
              f"(first {r12.iters}), x bitwise equal "
              f"{torch.equal(r12b.x, r12.x)}")
        print(f"phase 12 n=1000 LP (A 4000x1000 f32), profile='fast' -> "
              f"method={p12.method!r} accel={p12.accel!r} check_period="
              f"{p12.check_period}: CONVERGED in {r12.iters} iterations; "
              f"{fmt_direct(wall12, sp12)}; repeat {fmt_direct(wall12b, sp12b)}"
              f", same iterations, bitwise-equal x; objective {obj12:.6f} "
              f"vs HiGHS {hi['fun']:.6f} (rel {rel12:.2e}); launches {cnt12}",
              flush=True)

        # ---- phase 13: the n=4000 LP (A 16000x4000 f32, 256 MB) under
        # profile='fast': CONVERGED, and the residuals recomputed on the
        # host in f64 from the returned x and y each within 2e-3
        r13, wall13, cnt13, sp13 = slice_runs["LP n=4000, fast profile"]
        check(r13.converged, f"n=4000 LP fast profile status {r13.status}")
        kkt13 = lp_kkt(c3, a3, b3, r13.x.cpu().numpy(), r13.y.cpu().numpy())
        check(max(kkt13) <= 2e-3, "n=4000 LP residuals (primal, dual, gap) "
              f"{kkt13}")
        print(f"phase 13 n=4000 LP (A 16000x4000 f32), profile='fast': "
              f"CONVERGED in {r13.iters} iterations; "
              f"{fmt_direct(wall13, sp13)}; host f64 residuals primal "
              f"{kkt13[0]:.2e}, dual {kkt13[1]:.2e}, gap {kkt13[2]:.2e}; "
              f"launches {cnt13}", flush=True)

        # ---- phase 14: the exp/pow problems under profile='fast' go to the
        # direct engine: the logistic regression within 5e-3 of L-BFGS-B,
        # the GP and the growth portfolio within 5e-3 of SLSQP; kernel B
        # in every projection of the loop, dual_matvec in every check
        for prob_a, cone_ in ((a4t, lr_cone), (gprob.a.a, gprob.cone),
                              (a6t, gr_cone)):
            p14 = tconic._resolve_fast_profile(p_fast, tt.DenseOp(prob_a),
                                               cone_)
            check(p14.method == "direct", f"exp/pow fast profile: {p14}")
        r14, wall14, cnt14, sp14 = slice_runs[
            "logistic regression m=1000 n=20, fast profile"]
        check(r14.converged, f"logistic regression fast profile status "
              f"{r14.status}")
        lr_obj14 = logreg_objective(lr_x, lr_y,
                                    r14.x[:lr_n].double().cpu().numpy(), lam)
        lr_rel14 = abs(lr_obj14 - lr_ref) / abs(lr_ref)
        check(lr_rel14 <= 5e-3, f"logistic regression fast profile "
              f"objective {lr_obj14} vs L-BFGS-B {lr_ref} "
              f"(rel {lr_rel14:.3e})")
        check(cnt14["cone_proj"] >= r14.iters
              and cnt14["dual_matvec"] >= r14.iters // 20,
              f"logistic regression fast profile launches {cnt14} for "
              f"{r14.iters} iterations")
        r_gpf, wall_gpf, cnt_gpf, _ = slice_runs["GP n=100, fast profile"]
        check(r_gpf.converged, f"GP fast profile status {r_gpf.status}")
        xgf = np.exp(r_gpf.x[:gn].double().cpu().numpy())
        posy_f = [float(np.sum(ci * np.prod(xgf[None, :] ** ai, axis=1)))
                  for ci, ai in zip(gp_c, gp_a)]
        gp_rel_f = abs(posy_f[0] - gp_ref) / gp_ref
        check(gp_rel_f <= 5e-3 and max(posy_f[1:]) <= 1.01,
              f"GP fast profile objective {posy_f[0]} vs SLSQP {gp_ref} "
              f"(rel {gp_rel_f:.3e}), max f_i {max(posy_f[1:]):.4f}")
        r_grf, wall_grf, cnt_grf, _ = slice_runs[
            "growth portfolio S=64 n=50, fast profile"]
        check(r_grf.converged, f"growth fast profile status {r_grf.status}")
        growth_f = float(r_grf.x[gr_root])
        gr_rel_f = abs(growth_f - gr_ref) / gr_ref
        check(gr_rel_f <= 5e-3, f"growth fast profile {growth_f} vs SLSQP "
              f"{gr_ref} (rel {gr_rel_f:.3e})")
        # the caller turns TF32 on: the engine still runs every product in
        # full f32 (the same iterations, a bitwise-equal x) and gives the
        # caller's setting back
        torch.set_float32_matmul_precision("high")
        try:
            r_grf2 = tt.solve(c6t, a6t, b6t, gr_cone, p_fast_tight)
            caller = torch.get_float32_matmul_precision()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        check(caller == "high", f"caller's matmul precision reads {caller!r} "
              "after the solve, not 'high'")
        check(r_grf2.iters == r_grf.iters and torch.equal(r_grf2.x, r_grf.x),
              f"growth fast profile under TF32: {r_grf2.iters} iterations "
              f"(first {r_grf.iters}), x bitwise equal "
              f"{torch.equal(r_grf2.x, r_grf.x)}")
        print(f"phase 14 exp/pow on profile='fast' (the direct engine): "
              f"logistic regression CONVERGED in {r14.iters} iterations, "
              f"{fmt_direct(wall14, sp14)} (phase 6's host-loop pdhg: "
              f"{r_lr.iters} iterations, {wall_lr:.3f} s); objective "
              f"{lr_obj14:.6f} vs L-BFGS-B {lr_ref:.6f} (rel {lr_rel14:.2e});"
              f" launches {cnt14}, per iteration "
              f"{cnt14['cone_proj'] / r14.iters:.3f} cone_proj and "
              f"{cnt14['dual_matvec'] / r14.iters:.3f} dual_matvec. GP "
              f"{r_gpf.iters} iterations, {wall_gpf:.3f} s, objective "
              f"{posy_f[0]:.6f} vs SLSQP {gp_ref:.6f} (rel {gp_rel_f:.2e}); "
              f"growth portfolio {r_grf.iters} iterations, {wall_grf:.3f} s, "
              f"{growth_f:.6f} vs SLSQP {gr_ref:.6f} (rel {gr_rel_f:.2e}); "
              "repeat under set_float32_matmul_precision('high'): same "
              f"iterations, bitwise-equal x, caller's setting {caller!r}",
              flush=True)

        # ---- phase 15: the fast profile's mega-first branch on the card:
        # the n=100 LP and the n=50 QP take the megakernel; the same two
        # problems through method='direct', accel='halpern' converge to
        # objectives within 5e-3. The thresholds are the JAX package's TPU
        # crossovers; this reads both sides on the H100
        line15 = []
        for what, cvec, prob_a, cone_ in (
                ("LP n=100", c2t, a2t, lp2_cone),
                ("QP n=50", qprob.c, qprob.a.a, qprob.cone)):
            p15 = tconic._resolve_fast_profile(p_fast, tt.DenseOp(prob_a),
                                               cone_)
            rm, wm, cm, _ = slice_runs[f"{what}, fast profile"]
            rd, wd, cd, spd = slice_runs[f"{what}, direct Halpern"]
            check(p15.method == "pdhg" and p15.kernel == "auto"
                  and cm["megakernel"] == 1,
                  f"{what} fast profile: {p15}, launches {cm}")
            check(rm.converged and rd.converged,
                  f"{what}: status fast {rm.status}, direct {rd.status}")
            om, od = objective(cvec, rm), objective(cvec, rd)
            check(rel_obj(om, od) <= 5e-3, f"{what}: objective fast "
                  f"(megakernel) {om} vs direct {od}")
            m_, n_ = prob_a.shape
            line15.append(
                f"{what} (plan {mk.device_plan(m_, n_, cone_, dev)[0].describe()}"
                f"): megakernel {rm.iters} iterations, {1e3 * wm:.1f} ms; "
                f"direct Halpern {rd.iters} iterations, {fmt_direct(wd, spd)};"
                f" objectives {om:.6f} / {od:.6f} "
                f"(rel {rel_obj(om, od):.2e})")
        print("phase 15 fast profile mega-first: " + "; ".join(line15),
              flush=True)

        # ---- phase 16: accel='restart' on the n=100 LP, host loop, f32:
        # CONVERGED, objective within 5e-3 of phase 5's Halpern host loop
        r16, wall16, cnt16, _ = slice_runs["LP n=100, restart, host loop"]
        check(r16.converged, f"restart status {r16.status}")
        o16, o5 = objective(c2, r16), objective(c2, r_lp_x)
        check(rel_obj(o16, o5) <= 5e-3, f"restart objective {o16} vs "
              f"phase 5's {o5}")
        print(f"phase 16 accel='restart', n=100 LP host loop: CONVERGED in "
              f"{r16.iters} iterations, {wall16:.3f} s (phase 5's Halpern "
              f"host loop: {r_lp_x.iters} iterations, {wall_lp_x:.3f} s); "
              f"objective {o16:.6f} vs {o5:.6f} (rel {rel_obj(o16, o5):.2e});"
              f" launches {cnt16}", flush=True)
    finally:
        for name, fn in real_direct.items():
            setattr(tdirect, name, fn)
    for k in kernels:
        main_counts[k] += sum(r[2][k] for r in slice_runs.values())

    # ---- phase 16b: where the direct engine's time goes, 200 iterations
    # of its loop alone (the cache build left out) under torch.profiler,
    # on the n=1000 and n=4000 LPs and the logistic regression under
    # profile='fast'
    p_fast_prof = dataclasses.replace(p_fast, max_iter=200)
    real_loop = tdirect._run_halpern_dr
    for what, fn in (
            ("LP n=1000", lambda: tt.solve_jit(c1t, a1t, b1t, lp_cone,
                                               p_fast_prof)),
            ("LP n=4000", lambda: tt.solve_jit(c3t, a3t, b3t, lp3_cone,
                                               p_fast_prof)),
            ("logistic regression", lambda: tt.solve_jit(
                c4t, a4t, b4t, lr_cone, p_fast_prof))):
        stats, out = [], []

        def profiled_loop(*args, **kwargs):
            stats.append(profile_loop(
                lambda: out.append(real_loop(*args, **kwargs)), 200))
            return out[0]

        tdirect._run_halpern_dr = profiled_loop
        try:
            fn()
        finally:
            tdirect._run_halpern_dr = real_loop
        wall_us, busy_us, nlaunch, top = stats[0]
        print(f"phase 16b profile {what}, the direct engine's loop "
              f"(profile='fast'), 200 iterations: {wall_us:.1f} us wall and "
              f"{busy_us:.1f} us device-busy per iteration "
              f"({100 * busy_us / wall_us:.1f}% busy), {nlaunch:.1f} kernel "
              "launches per iteration; top kernels (us per iteration) "
              + ", ".join(f"{k} {t:.1f}" for k, t in top), flush=True)

    # ---- phases 17-19: checkpoint / resume, chunked solves, progress
    # logging and the Solver facade, each path driven once with the launch
    # counts set to 0 just before it
    EXCESS = tt.SolverStatus.EXCESS_ITER
    p_plain = dataclasses.replace(p_full, accel="")
    p_mega_plain = dataclasses.replace(p_mega, accel="")

    def lp100(p, **kw):
        return tt.solve_jit(c2t, a2t, b2t, lp2_cone, p, **kw)

    def qp50(p, **kw):
        return tt.solve_jit(qprob.c, qprob.a, qprob.b, qprob.cone, p, **kw)

    kept = {}  # every result of a path, by path name

    def keep(name, fn):
        def run():
            kept[name] = fn()
            out = kept[name]
            return out[-1] if isinstance(out, tuple) else out
        return run

    splits17 = {
        "LP n=100 split, host loop plain": (lp100, p_plain),
        "LP n=100 split, host loop halpern": (lp100, p_full),
        "LP n=100 split, host loop restart": (lp100, p_restart),
        "LP n=100 split, megakernel plain": (lp100, p_mega_plain),
        "QP n=50 split, megakernel plain": (qp50, p_mega_plain),
    }
    paths17 = {name: keep(name, lambda s=s_, p=p_: split_solve(s, p))
               for name, (s_, p_) in splits17.items()}
    p_full_st = dataclasses.replace(p_full, return_state=True)
    paths17["LP n=100 chunked 500, host loop halpern"] = keep(
        "chunked halpern", lambda: tt.solve(c2t, a2t, b2t, lp2_cone,
                                            p_full_st, chunk_iters=500))
    paths17["LP n=100 chunked 500, megakernel halpern"] = keep(
        "chunked mega", lambda: tt.solve(c2t, a2t, b2t, lp2_cone, p_mega,
                                         chunk_iters=500))
    paths17["LP n=100 resumed at CONVERGED, host loop halpern"] = keep(
        "frozen", lambda: lp100(p_full, resume_state=kept[
            "chunked halpern"].state))
    runs17 = drive(paths17, kernels)

    # ---- phase 17: resume on the pdhg engine, f32 on the card. Each split
    # (k iterations, then k more from the checkpoint) against one solve of
    # 2k: both EXCESS_ITER, the same global k, and x, y and every
    # criterion bitwise equal (the loops and the kernels sum in a fixed
    # order: a difference is a seam fault, not noise). Chunks of 500: the
    # host loop's Halpern solve takes phase 5's iterations to a bitwise x;
    # the megakernel's restarts its epoch at each chunk, so CONVERGED with
    # the objective within 5e-3 of phase 5's. A CONVERGED checkpoint
    # resumed takes 0 iterations to a bitwise x
    line17 = []
    for name in splits17:
        k17, whole, first, second = kept[name]
        check(first.status == second.status == whole.status == EXCESS,
              f"{name}: statuses {first.status}, {second.status}, whole "
              f"{whole.status}")
        check(second.state.k == whole.state.k == 2 * k17,
              f"{name}: k {second.state.k}, whole {whole.state.k}")
        diff = bitwise_diff(second, whole)
        check(diff == [], f"{name}: resumed at {k17} differs from the "
              f"whole solve in {diff}")
        line17.append(f"{name} {k17}+{k17}: bitwise")
    plans17 = [mk.device_plan(*a_.shape, cone_, dev)[0].grid
               for a_, cone_ in ((a2t, lp2_cone), (qprob.a.a, qprob.cone))]
    r_chx = kept["chunked halpern"]
    check(r_chx.iters == r_lp_x.iters and torch.equal(r_chx.x, r_lp_x.x),
          f"chunked host-loop LP: {r_chx.iters} iterations (phase 5 "
          f"{r_lp_x.iters}), x bitwise {torch.equal(r_chx.x, r_lp_x.x)}")
    r_chm = kept["chunked mega"]
    o_chm, o_5m = objective(c2, r_chm), objective(c2, r_lp_m)
    check(r_chm.converged and rel_obj(o_chm, o_5m) <= 5e-3,
          f"chunked megakernel LP: status {r_chm.status}, objective "
          f"{o_chm} vs phase 5's {o_5m}")
    r_frz = kept["frozen"]
    check(r_frz.converged and r_frz.iters == 0
          and torch.equal(r_frz.x, r_chx.x),
          f"CONVERGED checkpoint resumed: status {r_frz.status}, "
          f"{r_frz.iters} iterations, x bitwise "
          f"{torch.equal(r_frz.x, r_chx.x)}")
    cnt17 = {k: sum(r[2][k] for r in runs17.values()) for k in kernels}
    print("phase 17 resume on the pdhg engine (n=100 LP, QP n=50; "
          f"megakernel G={plans17[0]} and G={plans17[1]}): "
          + "; ".join(line17)
          + f"; chunks of 500, host loop Halpern {r_chx.iters} iterations "
          f"(phase 5 {r_lp_x.iters}), bitwise x, "
          f"{runs17['LP n=100 chunked 500, host loop halpern'][1]:.3f} s "
          f"(phase 5 {wall_lp_x:.3f} s); chunks of 500, megakernel "
          f"{r_chm.iters} iterations (unchunked {r_lp_m.iters}), objective "
          f"{o_chm:.6f} vs {o_5m:.6f} (rel {rel_obj(o_chm, o_5m):.2e}); "
          f"CONVERGED checkpoint resumed: 0 iterations, bitwise x; "
          f"launches {cnt17}", flush=True)

    # ---- phase 18: chunked direct engine at full width (profile='fast'):
    # the n=4000 LP in chunks of 2,000 and the logistic regression in
    # chunks of 1,000 take the unchunked solves' iterations (phases 13 and
    # 14) to a bitwise x, and build the cache once (spd_cache wrapped).
    # Each runs right after a repeat of the unchunked solve, so the two
    # walls see the same host; the host-bound loop's wall drifts by tens
    # of percent over a run, so chunking's own cost is read apart too:
    # the time outside the loop and the cache build
    spans18 = []
    real18 = time_calls(tdirect, ("spd_cache", "newton_schulz_inverse",
                                  "_run_halpern_dr", "_run_plain"), spans18)
    cells18 = (
        ("n=4000 LP", 2000, r13,
         lambda **kw: tt.solve(c3t, a3t, b3t, lp3_cone, p_fast, **kw)),
        ("logistic regression", 1000, r14,
         lambda **kw: tt.solve(c4t, a4t, b4t, lr_cone, p_fast, **kw)))
    paths18 = {}
    for what, chunk, _, fn in cells18:
        paths18[f"{what}, fast profile, unchunked"] = fn
        paths18[f"{what}, fast profile, chunks of {chunk}"] = \
            lambda f=fn, n_=chunk: f(chunk_iters=n_)
    try:
        runs18 = drive(paths18, kernels, spans18)
    finally:
        for name, fn in real18.items():
            setattr(tdirect, name, fn)

    def outside_ms(wall, sp):
        """Wall ms outside the direct engine's loop and cache build."""
        return 1e3 * wall - span_ms(sp, "_run_halpern_dr") \
            - span_ms(sp, "spd_cache")

    line18 = []
    for what, chunk, r_first, _ in cells18:
        r_u, wall_u, _, sp_u = runs18[f"{what}, fast profile, unchunked"]
        r_c, wall_c, cnt_c, sp_c = runs18[
            f"{what}, fast profile, chunks of {chunk}"]
        builds = sum(1 for n_, _, _ in sp_c if n_ == "spd_cache")
        loops = sum(1 for n_, _, _ in sp_c if n_ == "_run_halpern_dr")
        check(r_c.converged and r_c.iters == r_u.iters == r_first.iters
              and torch.equal(r_c.x, r_u.x) and torch.equal(r_c.x, r_first.x),
              f"{what} chunked: status {r_c.status}, {r_c.iters} iterations "
              f"(unchunked {r_u.iters}, first {r_first.iters}), x bitwise "
              f"{torch.equal(r_c.x, r_u.x)}")
        check(builds == 1, f"{what} chunked: {builds} cache builds")
        seam = outside_ms(wall_c, sp_c) - outside_ms(wall_u, sp_u)
        line18.append(
            f"{what}: {r_c.iters} iterations in {loops} chunks, bitwise x, "
            f"1 cache build ({span_ms(sp_c, 'spd_cache'):.1f} ms); wall "
            f"chunked {1e3 * wall_c:.1f} ms, unchunked just before "
            f"{1e3 * wall_u:.1f} ms ({1e3 * (wall_c - wall_u):+.1f} ms, "
            f"{100 * (wall_c - wall_u) / wall_u:+.2f}%); loop "
            f"{span_ms(sp_c, '_run_halpern_dr'):.1f} / "
            f"{span_ms(sp_u, '_run_halpern_dr'):.1f} ms; outside the loop "
            f"and the build {outside_ms(wall_c, sp_c):.1f} / "
            f"{outside_ms(wall_u, sp_u):.1f} ms, so {seam:+.1f} ms for "
            f"{loops - 1} seams ({seam / max(1, loops - 1):+.2f} ms "
            "each); "
            f"launches {cnt_c}")
    print("phase 18 chunked direct engine: " + "; ".join(line18),
          flush=True)

    # ---- phase 19: progress logging and the Solver facade. Phase 5's
    # host-loop LP with log_period=500 prints one line per logged check,
    # each parsed back to the loop's k; kernel='auto' with logging warns
    # and keeps the host loop; the golden LP in f64 through
    # Solver().par(...) takes 160 iterations on the card
    import warnings
    p_log = dataclasses.replace(p_full, log_period=500)
    logged = io.StringIO()

    def logged_solve():
        with contextlib.redirect_stdout(logged):
            return tt.solve(c2t, a2t, b2t, lp2_cone, p_log)

    def auto_logged():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with contextlib.redirect_stdout(io.StringIO()):
                r = tt.solve_jit(c2t, a2t, b2t, lp2_cone, dataclasses.replace(
                    p_log, kernel="auto", max_iter=200))
        kept["auto warnings"] = [str(w.message) for w in seen
                                 if issubclass(w.category, RuntimeWarning)]
        return r

    solver19 = tt.Solver().par(lambda q: setattr(q, "max_iter", 100_000))
    runs19 = drive({
        "LP n=100, host loop halpern, log_period=500": logged_solve,
        "LP n=100, host loop halpern, unlogged":
            lambda: tt.solve(c2t, a2t, b2t, lp2_cone, p_full),
        "LP n=100, kernel='auto', log_period=500": auto_logged,
        "golden LP f64, Solver().par(...)":
            lambda: solver19.solve((c, a, b, golden_cone)),
    }, kernels)
    r_log, wall_log, cnt_log, _ = runs19[
        "LP n=100, host loop halpern, log_period=500"]
    got_ks = log_ks(logged.getvalue())
    want_ks = logged_ks(r_log.iters, p_log.check_period, p_log.log_period)
    check(r_log.iters == r_lp_x.iters and torch.equal(r_log.x, r_lp_x.x),
          f"logged LP: {r_log.iters} iterations (phase 5 {r_lp_x.iters})")
    check(got_ks == want_ks, f"logged LP printed the checks {got_ks}, not "
          f"{want_ks}")
    r_unl, wall_unl, _, _ = runs19["LP n=100, host loop halpern, unlogged"]
    check(r_unl.iters == r_log.iters and torch.equal(r_unl.x, r_log.x),
          f"unlogged repeat: {r_unl.iters} iterations (logged "
          f"{r_log.iters})")
    r_auto, _, cnt_auto, _ = runs19["LP n=100, kernel='auto', log_period=500"]
    check(any("megakernel" in w for w in kept["auto warnings"])
          and cnt_auto["megakernel"] == 0 and cnt_auto["dual_matvec"] > 0
          and r_auto.iters == 200,
          f"kernel='auto' with logging: warnings {kept['auto warnings']}, "
          f"launches {cnt_auto}, {r_auto.iters} iterations")
    r_fac, wall_fac, _, _ = runs19["golden LP f64, Solver().par(...)"]
    check(r_fac.iters == 160 and r_fac.x.device.type == "cuda",
          f"golden LP through Solver: {r_fac.iters} iterations on "
          f"{r_fac.x.device}")
    print(f"phase 19 logging: {len(got_ks)} lines at k = {got_ks[0]}, "
          f"{got_ks[1]}, ..., {got_ks[-1]} (one per logged check), "
          f"{r_log.iters} iterations, bitwise phase 5's x; "
          f"{1e6 * wall_log / r_log.iters:.1f} us per iteration logged, "
          f"{1e6 * wall_unl / r_unl.iters:.1f} unlogged just after "
          f"({100 * (wall_log - wall_unl) / wall_unl:+.2f}%); "
          "kernel='auto' with logging warned and kept the host loop "
          f"(launches {cnt_auto}); golden LP f64 through Solver().par(...): "
          f"{r_fac.iters} iterations, {1e3 * wall_fac:.1f} ms", flush=True)
    for runs in (runs17, runs18, runs19):
        for k in kernels:
            main_counts[k] += sum(r[2][k] for r in runs.values())

    # ---- phases 20-22: the structured operators and the indirect engine
    for k, v in structured_phases(tt, dev, kernels).items():
        main_counts[k] += v

    # ---- phases 23-26: the PSD and custom cones, the SDP, SOCP and QCQP
    # builders, against the f64 CPU references the child computed
    t23 = time.perf_counter()
    counts26, jacobi_record = sdp_phases(
        tt, dev, kernels, refs, grid24=REF_KW["grid24"],
        torus=REF_KW["torus"], traj=REF_KW["traj"])
    for k, v in counts26.items():
        main_counts[k] += v
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s "
          "(phases 23-26 from "
          f"{t23 - t_start:.1f} s)", flush=True)

    primal = cp_main[False]
    record = {"kernels": [
        {"name": "dual_matvec", "route": "cuda",
         "source": "totsu_tpu_torch/csrc/dual_matvec.cu",
         "replaces": "totsu_tpu/ops/pallas/dual_matvec.py:54",
         "launches": main_counts["dual_matvec"],
         "max_abs_err": max(r[0] for r in dm_main.values()),
         "ms": times[str(torch.float32)][0],
         "plain_ms": times[str(torch.float32)][1],
         "bound_ms": dm_bound[0], "bound_by": dm_bound[1],
         "library_ms": dm_library_ms,
         "device_ms": dm_rand["device"][0],
         "library_device_ms": dm_rand["device"][2]},
        {"name": "megakernel", "route": "cuda",
         "source": "totsu_tpu_torch/csrc/megakernel.cu",
         "replaces": "totsu_tpu/ops/pallas/megakernel.py:184",
         "launches": main_counts["megakernel"],
         "max_abs_err": mk_gp[4], "ms": 1e3 * mk_gp[2],
         "plain_ms": 1e3 * mk_gp[3], "bound_ms": mk_gp[5][0],
         "bound_by": mk_gp[5][1], "library_ms": None,
         "grid": plans["GP n=100"].grid},
        {"name": "cone_proj", "route": "cuda",
         "source": "totsu_tpu_torch/csrc/cone_proj.cu",
         "replaces": "totsu_tpu/solver/cone.py:368",
         "launches": main_counts["cone_proj"],
         "max_abs_err": max(r[0] for r in cp_main.values()),
         "ms": primal[1], "plain_ms": primal[2],
         "bound_ms": primal[3][0], "bound_by": primal[3][1],
         "library_ms": None, "device_ms": primal[6]},
        jacobi_record,
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-references"]:
        print(json.dumps(cpu_references(**json.loads(sys.argv[2]))))
    else:
        main()
