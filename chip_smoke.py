"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the four CUDA kernels of the port from ``totsu_tpu_torch/csrc``
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
itself); polish on the card (phase 27: the n=1000 LP in f32 and f64, the
n=50 QP on the megakernel, the partitioning SDP at k = 48, which the
polish declines, and at k = 6, which it accepts) and differentiation
through solves (phase 28: DPi in closed form against central differences
of kernels B and J, the n=300 LP's gradients in f64 against HiGHS's
active-set closed form and its forward-mode tangent, the JAX package's
f32 box LP, a BlockedEllOp's tile cotangent against its dense twin's);
lockstep batches (phases 29-33: bench.py's batch cells, 8 and 64 n=100
LPs, 32 growth portfolios with kernel B taking every lane's exp and pow
blocks in one launch, chunking, 512 nearest-correlation SDPs with kernel
J taking every lane's PSD block in one launch, each held against single
solves; BatchRunner's MPC fleet and a burst of 128 requests through
submit; consensus ADMM against the joint LP and the trajectory sweep);
the batched megakernel (phase 36: batch64 and batch8 and the 32 growth
portfolios in one launch each, lanes bitwise their one-lane launches,
512 QPs past one resident wave, profile='fast' and a BatchRunner burst
on kernel='auto'); each example's main on the card (phase 37, the
examples' own builders, which the other phases import too);
distribution (phase 34: ranks spawned as processes that join through
multihost.init, the n=1000 LP row-sharded on a 1-rank NCCL world and on
2 gloo ranks sharing the card, kernel 1 on each rank's rows, the
from-tiles blocked-ELL LP, the batch64 cell and the ADMM fleet sharded,
each against its unsharded solve, with the collectives counted); the
native C++ engine (phase 35: kernel B against its bisection
projections, the golden LP); batches of structured operators (phase
38: four banded box LPs as a BatchedOp of BlockedEllOps on the indirect
engine against HiGHS and their single solves, chunked, and on pdhg
graphed against eager; eight structured partitioning SDPs with kernel J
taking every lane's block in each launch; the VStackOp, ScaledOp,
SparseOp and stencil CustomOp batches against the BlockedEllOp batch;
the batch-leading differentiable solver's tile cotangents).
Each phase prints one line of its own
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
import itertools
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

# the examples' own builders: the smoke solves the same instances
from examples_torch import (growthport_powexp,  # noqa: E402
                            nearestcorr_batch_sdp, toruscompl_socp,
                            trajplan_qcqp)
from examples_torch.growthport_powexp import make_growth  # noqa: E402
from examples_torch.logreg_expcone import make_logreg  # noqa: E402
from examples_torch.nearestcorr_batch_sdp import (  # noqa: E402
    make_noisy_covs)
from examples_torch.partitioning_sdp import (  # noqa: E402
    grid_weights, make_partitioning, pack_index, packed_matrix)

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


def growth_reference(returns, h_budget):
    """examples/growthport_powexp.py's oracle (SLSQP on the log-form
    NLP): the optimal geometric mean."""
    return float(growthport_powexp.scipy_oracle(returns, h_budget)[0])


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


def nearestcorr_data(k):
    """examples/nearestcorr_batch_sdp.py build (:53-84) in numpy, without
    its layout: over u = (packed scaled X, t), min t subject to (t, x -
    vec(S)) in SOC, x in vec(PSD_k), diag(X) = 1. Returns (a, c, sn); the
    layout is SOC(1 + sn), PSD(k), zero(k)."""
    a, c, _, _, sn = nearestcorr_batch_sdp.build(k, torch.float64, "cpu")
    return a.numpy(), c.numpy(), sn


def nearestcorr_b(s_mat):
    """b of one instance (the example's ``lane_b``): [0; -vec(S) scaled;
    0; 1]."""
    k = s_mat.shape[0]
    sn = k * (k + 1) // 2
    return nearestcorr_batch_sdp.lane_b(s_mat, k, sn, torch.float64,
                                        "cpu").numpy()


def make_trajplan(t_cap=30, a_cap=90.0):
    """examples/trajplan_qcqp.py build (:22-83): P0..Pm, q, r, A, b of the
    2-D trajectory QCQP (minimum squared velocity, |acceleration| <=
    a_cap, pinned ends and two waypoints)."""
    return trajplan_qcqp.build(t_cap, a_cap)[:5]


def make_torus(x_num=9, y_num=7, vol_ratio=0.2):
    """examples/toruscompl_socp.py build (:19-127): the truss compliance
    SOCP on a torus grid. Returns (f, g_list, h_list, c_list, d_list, a,
    b, l, vlen)."""
    return toruscompl_socp.build(x_num, y_num, vol_ratio)[:9]


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


class BatchLaunches:
    """The batched megakernel's launch count (``megakernel.batch_launches``)
    read and reset as ``launches``, as every kernel's count is here: the
    single solve's launches (``megakernel.launches``) and the batch's are
    counted apart."""

    def __init__(self, mk):
        self.mk = mk

    @property
    def launches(self):
        return self.mk.batch_launches

    @launches.setter
    def launches(self, value):
        self.mk.batch_launches = value


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
#: SDP grid (k = 48), torus SOCP and trajectory QCQP, and phase 27c's
#: small partitioning grid (k = 6, a point the polish accepts)
REF_KW = dict(lp_n=1000, grid24=(8, 6), torus=(9, 7), traj=(30, 90.0),
              grid27=(3, 2))

#: phase 23's (k, count): the nearest-correlation solves' launch (one
#: instance a solve; the kernels record's row), the lockstep batch of 16,
#: the auto rule's regime (k <= 16, count >= 64), the reference's
#: partitioning order and benchmark_sdp.py's larger ones (phase 25
#: launches (128, 1))
PHASE23_SHAPES = ((8, 1), (8, 16), (8, 512), (16, 64), (48, 1), (128, 1),
                  (128, 16), (256, 1))


def cpu_references(lp_n, grid24, torus, traj, grid27=(3, 2), cores=None):
    """The CPU references of phases 4 and 24-26, in f64 (this runs in a
    child process beside the card's phases, on the CPU only, pinned to
    ``cores`` where given; the cores it ran on come back as ``cores``):
    * HiGHS on phase 4's n = ``lp_n`` benchmark LP: status, message,
      objective, x and its seconds;
    * the partitioning SDP's objective <W, X> from the port's f64 solve
      at eps_acc 1e-6 (the structured form of phase 25, the same problem
      as phase 24's dense one: [diag(-dscale); selection] is the dense
      A's own matrix), pdhg with Halpern, check_period 20; the same at
      the small grid ``grid27`` to eps_acc 1e-9;
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
    def partitioning(grid, eps):
        w, c, neg_d, sel, b = make_partitioning_structured(grid[0] * grid[1])
        l = w.shape[0]
        op = tt.VStackOp((tt.DiagOp(torch.tensor(neg_d, dtype=f64)),
                          tt.DenseOp(torch.tensor(sel, dtype=f64))))
        r = tt.solve_jit(
            torch.tensor(c, dtype=f64), op, torch.tensor(b, dtype=f64),
            tt.ConeLayout([tt.psd(l, method="eigh"), tt.zero(l)]),
            tt.SolverParam(max_iter=200_000, eps_acc=eps, accel="halpern",
                           check_period=20))
        return float(np.trace(w @ packed_matrix(r.x.numpy(), l))), r

    obj, r = partitioning(grid24, 1e-6)
    obj27, r27 = partitioning(grid27, 1e-9)
    out = {"lp": lp, "partitioning": obj, "partitioning_iters": r.iters,
           "partitioning_status": r.status, "partitioning27": obj27,
           "partitioning27_status": r27.status,
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


# ---- phases 27-28: polish and differentiation through solves

#: phase 28d's banded box LP size (phase 21's is 4096: its f64 forward and
#: backward took 41 s of the script's time limit)
ELL_N28D = 1024

#: phase 28's LSQR cap. The default 1,000 steps stop far short on the
#: benchmark LP family (both packages, the CPU: at n = 300 the b gradient
#: is 62% off after 1,000 steps and exact, 5e-9, after the 12,742 that
#: rtol 1e-12 takes), so the phase runs LSQR to its tolerance
LSQR_ITERS28 = 200_000

#: phase 28a's factors: (name, factor); z, v and w are drawn N(0, 1)
DPI28 = (("R+", ("rpos", 4000)), ("SOC", ("soc", 5, 400)),
         ("RSOC", ("rsoc", 52, 20)), ("exp", ("expc", 2000)),
         ("pow(1/2)", ("powc", 0.5, 2000)),
         ("PSD (48, 1) jacobi", ("psd", 48, 1)),
         ("PSD (8, 512) jacobi", ("psd", 8, 512)))


def dpi_factor(tt, spec):
    """Phase 28a's factor from its (maker, args...) entry."""
    name, *args = spec
    if name == "psd":
        return tt.psd(*args, method="jacobi")
    return getattr(tt, name)(*args)


def exp_kink_free(v, p):
    """(count,) mask of the exp blocks ``v`` (primal projections ``p``)
    away from the cone's kinks: the projection optimal (<p, v - p> = 0 to
    1e-12 |v|^2; the root finder stalls on about 1 block in 10,000
    standard-normal ones) and not within 1e-3 |v| of the edge s = 0, where
    central differences at h = 1e-6 see the edge."""
    nv = torch.linalg.vector_norm(v, dim=1)
    optimal = ((p * (v - p)).sum(dim=1).abs() <= 1e-12 * nv * nv)
    edge = (p[:, 1] > 0) & (p[:, 1] < 1e-3 * nv)
    return optimal & ~edge


def dpi_phase(tt, dev, kernels, specs=DPI28, h=1e-6, seed=28):
    """Phase 28a: DPi in closed form (``solver/dproj.py``) against central
    differences of the card's own projection (kernel B for exp/pow,
    kernel J for a 'jacobi' PSD factor) in f64, for the dual cone as the
    diff's y part projects it: relative 1e-6 over the factor's blocks
    away from the kinks, and <DPi v, w> against <v, DPi^T w> to 1e-12.
    Returns the kernels' launches in the DPi builds (the diff's own
    calls), and the line's parts."""
    from totsu_tpu_torch.solver import cone as tc, dproj
    f64 = torch.float64
    rng = np.random.default_rng(seed)
    counts = {k: 0 for k in kernels}
    parts = []
    for name, spec in specs:
        f = dpi_factor(tt, spec)

        def draw():
            return torch.from_numpy(rng.normal(size=f.total)).to(dev, f64)

        z, v, w = draw(), draw(), draw()
        for mod in kernels.values():
            mod.launches = 0
        u, fwd, bwd = dproj.factor_dproj(f, z, True)
        dv = fwd(v)
        torch.cuda.synchronize()
        built = {k: mod.launches for k, mod in kernels.items()}
        for k in kernels:
            counts[k] += built[k]
        proj = tc._project_factor(f, z, True)
        fd = (tc._project_factor(f, z + h * v, True)
              - tc._project_factor(f, z - h * v, True)) / (2 * h)
        keep = torch.ones(f.count, dtype=torch.bool, device=dev)
        if f.kind == tc.EXP:
            vk = -z.reshape(-1, 3)
            keep = exp_kink_free(vk, (proj - z).reshape(-1, 3))
        blk = f.total // f.count
        d_k = (dv - fd).reshape(-1, blk)[keep]
        f_k = fd.reshape(-1, blk)[keep]
        err = float(torch.linalg.vector_norm(d_k)
                    / torch.linalg.vector_norm(f_k))
        lhs = float(dv @ w)
        adj = abs(lhs - float(v @ bwd(w))) / max(abs(lhs), 1.0)
        check(torch.equal(u, proj), f"DPi {name}: u is not the card's own "
              "projection")
        check(err <= 1e-6 and adj <= 1e-12,
              f"DPi {name}: relative error {err:.3e} against central "
              f"differences (limit 1e-6), adjoint {adj:.3e} (limit 1e-12)")
        kept = int(keep.sum())
        parts.append(f"{name} {err:.1e} / {adj:.0e}"
                     + (f" ({kept} of {f.count} blocks kept)"
                        if kept < f.count else "")
                     + (f", launches {built}" if any(built.values())
                        else ""))
    return counts, parts


def lsqr_profile(diff, dproj, cone, c, a_op, b, x, y, steps):
    """(wall us, device-busy us, launches) per LSQR step of the backward
    at the solution (x, y), ``steps`` steps under torch.profiler."""
    n, m = c.shape[0], b.shape[0]
    z = diff._embed_point(x, y, b - a_op.matvec(x))
    dp = dproj.dproj_at(cone, n, m, z)
    m_apply, mt_apply = diff._m_ops(dp, c, a_op, b)
    rhs = dp.apply_t(torch.cat([x, y, torch.zeros(1, dtype=x.dtype,
                                                  device=x.device)]))
    return profile_loop(lambda: diff._lsqr(mt_apply, m_apply, rhs, steps,
                                           0.0), steps)


def active_closed_form(a, b, x):
    """(d ||x||^2 / db, |B|) of an LP vertex x of A x <= b from its active
    set B (slack within 1e-9 (1 + |b|)): 2 A_B^-T x on B, 0 elsewhere,
    when |B| = n."""
    slack = b - a @ x
    act = np.nonzero(slack <= 1e-9 * (1.0 + np.abs(b)))[0]
    grad = np.zeros_like(b)
    if len(act) == a.shape[1]:
        grad[act] = 2.0 * np.linalg.solve(a[act].T, x)
    return grad, len(act)


def ell_tile_cotangent(tt, ell, g_blocks, g_blocks_t, m, n, bm):
    """The dense (m, n) A cotangent of a BlockedEllOp's tile cotangents:
    ``blocks``' stored (not zero-padded) slots plus ``blocks_t``'s
    transposed, and the mask of the stored tiles."""
    def used(blocks):
        return (blocks.abs().sum(dim=(1, 3)) > 0)[:, None, :, None]

    fwd = tt.BlockedEllOp(g_blocks * used(ell.blocks), ell.cols,
                          ell.blocks_t, ell.cols_t, m=m, n=n, bm=bm,
                          bn=bm).to_dense()
    bwd = tt.BlockedEllOp(g_blocks_t * used(ell.blocks_t), ell.cols_t,
                          ell.blocks, ell.cols, m=n, n=m, bm=bm,
                          bn=bm).to_dense()
    tiles = tt.BlockedEllOp(torch.ones_like(ell.blocks) * used(ell.blocks),
                            ell.cols, ell.blocks_t, ell.cols_t, m=m, n=n,
                            bm=bm, bn=bm).to_dense() > 0
    return fwd + bwd.T, tiles


def polish_diff_phases(tt, dev, kernels, refs, lp_n=1000, qp_n=50,
                       grid=(8, 6), grid27=(3, 2), box_n=700, ell_n=4096,
                       dpi=DPI28, prof_steps=50, lsqr_iters=LSQR_ITERS28,
                       diff_n=300):
    """Phases 27-28: polish and differentiation through solves on the card
    (the sizes are arguments only so that the flow can be rehearsed
    small). ``refs()`` returns the CPU references (HiGHS's x for the
    n = ``lp_n`` LP, the partitioning SDP's f64 objective); 28b's LP is
    ``make_lp(diff_n)``, its HiGHS vertex solved here. Each path is
    driven once through solve(..., polish=True) or a differentiable
    solver, the launch counts set to 0 just before it. Returns the
    kernels' launch counts over these paths."""
    from totsu_tpu_torch import diff
    from totsu_tpu_torch.solver import dproj
    from totsu_tpu_torch.solver import polish as tpolish
    f32, f64 = torch.float32, torch.float64
    counts = {k: 0 for k in kernels}
    # the launch gates hold on the card; a CPU rehearsal runs the plain
    # versions, which count nothing
    on_card = dev.type == "cuda"

    def count(runs):
        for r in runs.values():
            for k in kernels:
                counts[k] += r[2][k]

    def rel2(got, want):
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    spans = []
    real = time_calls(tpolish, ("host_matrix", "polish"), spans)
    try:
        # ---- phase 27: polish on the card. 27a: the n=1000 benchmark LP,
        # phase 12's f32 fast-profile solve (the direct engine, eps_acc
        # 1e-3) with polish=True, then an f64 solve at eps_acc 1e-6; the
        # polished point must reach residuals <= 1e-9 and HiGHS's vertex.
        # The polish declines the f32 point in both packages (the JAX
        # package on the CPU: polished=False from its f32 solves at
        # eps_acc 1e-3 and 1e-4, candidates at residuals 9e-3 and 3e-3):
        # it then returns the solve unchanged, which the phase checks
        t27 = time.perf_counter()
        c1, a1, b1 = make_lp(lp_n)
        lp_cone = tt.ConeLayout([tt.rpos(a1.shape[0])])
        p_fast = tt.SolverParam(profile="fast", eps_acc=1e-3,
                                max_iter=200_000)
        p_f64 = tt.SolverParam(profile="fast", eps_acc=1e-6,
                               max_iter=400_000)
        t32 = [torch.from_numpy(v).to(dev) for v in (c1, a1, b1)]
        t64 = [v.double() for v in t32]
        runs27 = {}
        split27 = {}
        plain = tt.solve(*t32, lp_cone, p_fast)
        for name, data, p in (("f32", t32, p_fast), ("f64", t64, p_f64)):
            spans.clear()
            runs27[name] = drive({f"LP n={lp_n} {name}, polish": (
                lambda: tt.solve(*data, lp_cone, p, polish=True))},
                kernels)
            count(runs27[name])
            split27[name] = (span_ms(spans, "host_matrix"),
                             span_ms(spans, "polish"))
        hi = refs()["lp"]
        xh = np.asarray(hi["x"], np.float64)
        a64, b64 = a1.astype(np.float64), b1.astype(np.float64)
        _, n_act = active_closed_form(a64, b64, xh)
        line27 = []
        for name, runs in runs27.items():
            (r, wall, cnt, _), = runs.values()
            dense_ms, passes_ms = split27[name]
            polished = r.x.dtype == f64
            if not polished:
                check(name == "f32" and torch.equal(r.x, plain.x)
                      and r.iters == plain.iters,
                      f"LP n={lp_n} {name}: the polish declined and the "
                      "result is not the solve's own")
                line27.append(f"{name} (eps_acc 1e-3, {r.iters} "
                              "iterations): not polished "
                              f"(the JAX package's answer), the solve "
                              f"returned unchanged; polish {wall:.3f} s "
                              f"of which A to the host {dense_ms:.1f} ms, "
                              f"active-set passes {passes_ms:.1f} ms")
                continue
            x = r.x.cpu().numpy()
            dx = rel2(x, xh)
            obj = abs(float(c1.astype(np.float64) @ x) - hi["fun"]) \
                / abs(hi["fun"])
            gate_x = n_act == len(x)
            check(float(r.cri_pri) <= 1e-9 and float(r.cri_dual) <= 1e-9
                  and (dx <= 1e-6 if gate_x else obj <= 1e-9),
                  f"LP n={lp_n} {name} polished: cri_pri "
                  f"{float(r.cri_pri):.2e}, cri_dual "
                  f"{float(r.cri_dual):.2e} (limit 1e-9), x from HiGHS's "
                  f"{dx:.2e}, objective {obj:.2e} ({n_act} active rows)")
            line27.append(
                f"{name} ({r.iters} iterations): polished, cri_pri "
                f"{float(r.cri_pri):.1e}, cri_dual {float(r.cri_dual):.1e}"
                f", x from HiGHS's {dx:.1e} (relative 2-norm; vertex with "
                f"{n_act} active rows{'' if gate_x else ', degenerate: objective gated'}"
                f"), objective {obj:.1e}; {1e3 * wall:.1f} ms with the "
                f"solve, of which A to the host {dense_ms:.1f} ms, "
                f"active-set passes {passes_ms:.1f} ms")
        print(f"phase 27a LP n={lp_n} (A {a1.shape[0]}x{lp_n}), "
              "solve(..., polish=True): " + "; ".join(line27)
              + f"; {time.perf_counter() - t27:.1f} s", flush=True)

        # ---- 27b: the n=50 QP under profile='fast' on the megakernel
        # (RSOC(52) + R+(50)), polished through the RSOC rotation
        t27b = time.perf_counter()
        qprob = tt.problems.qp(*[torch.from_numpy(v).to(dev)
                                 for v in make_qp(qp_n)])
        spans.clear()
        runs27b = drive({f"QP n={qp_n} fast profile, polish": lambda: (
            tt.solve(qprob.c, qprob.a, qprob.b, qprob.cone, p_fast,
                     polish=True))}, kernels)
        count(runs27b)
        (rq, wall_q, cnt_q, _), = runs27b.values()
        check(float(rq.cri_pri) <= 1e-9 and float(rq.cri_dual) <= 1e-9
              and rq.x.dtype == f64
              and (cnt_q["megakernel"] >= 1 or not on_card),
              f"QP n={qp_n} polished: cri_pri {float(rq.cri_pri):.2e}, "
              f"cri_dual {float(rq.cri_dual):.2e} (limit 1e-9), x "
              f"{rq.x.dtype}, launches {cnt_q}")
        print(f"phase 27b QP n={qp_n} (A {qprob.shape[0]}x{qprob.shape[1]}"
              f" f32, RSOC({qp_n + 2}) + R+({qp_n})), profile='fast' on "
              f"the megakernel ({rq.iters} iterations), polished: cri_pri "
              f"{float(rq.cri_pri):.1e}, cri_dual {float(rq.cri_dual):.1e};"
              f" {1e3 * wall_q:.1f} ms with the solve, of which A to the "
              f"host {span_ms(spans, 'host_matrix'):.1f} ms, active-set "
              f"passes {span_ms(spans, 'polish'):.1f} ms; launches "
              f"{cnt_q}; {time.perf_counter() - t27b:.1f} s", flush=True)

        # ---- 27c: phase 24's partitioning SDP (k = 48, dense, f32,
        # eps_acc 1e-3, the reference profile) polished through the PSD
        # active face: residuals no worse than before, accepted or not
        # (at k = 48 no candidate beats the f32 point, in either
        # package); then the same family on the grid ``grid27`` (k = 6),
        # whose polish must be accepted and reach the child's f64
        # objective within 1e-6
        def face(grid, ref_key, must_accept):
            t27c = time.perf_counter()
            w24, c24, f_24, a24, b24 = make_partitioning(*grid)
            l24 = w24.shape[0]
            prob24 = tt.problems.sdp(*(
                torch.tensor(v, dtype=f32, device=dev)
                for v in (c24, f_24, a24, b24)))
            p24 = tt.SolverParam(max_iter=200_000, eps_acc=1e-3)
            r24 = prob24.solve_jit(p24)
            check(r24.converged, f"partitioning SDP status {r24.status}")
            spans.clear()
            runs27c = drive({f"partitioning SDP k={l24}, polish": lambda: (
                tt.solve(prob24.c, prob24.a, prob24.b, prob24.cone, p24,
                         polish=True))}, kernels)
            count(runs27c)
            (rs, wall_s, cnt_s, _), = runs27c.values()
            accepted = rs.x.dtype == f64
            obj_s = float(np.trace(w24 @ packed_matrix(
                rs.x.double().cpu().numpy(), l24)))
            ref_s = refs()[ref_key]
            crit = [(float(r.cri_pri), float(r.cri_dual))
                    for r in (r24, rs)]
            check(accepted or not must_accept, f"partitioning SDP k={l24}: "
                  f"the polish declined (residuals {crit[0]})")
            if accepted:
                check(max(crit[1]) <= max(crit[0])
                      and abs(obj_s - ref_s) <= 1e-6 * abs(ref_s),
                      f"partitioning SDP k={l24} polished: residuals "
                      f"{crit[1]} (before {crit[0]}), objective {obj_s} vs "
                      f"the f64 reference {ref_s}")
            else:
                check(torch.equal(rs.x, r24.x) and crit[1] == crit[0],
                      f"partitioning SDP k={l24}: the polish declined and "
                      "the result is not the solve's own")
            print(f"phase 27c partitioning SDP k={l24} (A {prob24.shape[0]}"
                  f"x{prob24.shape[1]} f32, {rs.iters} iterations, cri_pri "
                  f"/ cri_dual {crit[0][0]:.1e} / {crit[0][1]:.1e}): polish "
                  + (f"accepted, residuals {crit[1][0]:.1e} / "
                     f"{crit[1][1]:.1e}" if accepted else
                     "not accepted (no candidate improves the worst KKT "
                     "residual; the solve is returned unchanged)")
                  + f"; objective {obj_s:.10f} vs the f64 reference "
                  f"{ref_s:.10f} (rel {abs(obj_s - ref_s) / abs(ref_s):.1e}"
                  f"{', limit 1e-6' if accepted else ''}); "
                  f"{1e3 * wall_s:.1f} ms with the solve, of which A to "
                  f"the host {span_ms(spans, 'host_matrix'):.1f} ms, "
                  f"active-set passes {span_ms(spans, 'polish'):.1f} ms; "
                  f"launches {cnt_s}; {time.perf_counter() - t27c:.1f} s",
                  flush=True)

        face(grid, "partitioning", False)
        face(grid27, "partitioning27", True)
    finally:
        for name, fn in real.items():
            setattr(tpolish, name, fn)

    # ---- phase 28: differentiation on the card. 28a: DPi against the
    # kernels
    t28 = time.perf_counter()
    cnt28a, parts28a = dpi_phase(tt, dev, kernels, dpi)
    for k in kernels:
        counts[k] += cnt28a[k]
    print("phase 28a DPi in closed form against central differences (h = "
          "1e-6) of the card's own projections, f64, dual cones (relative "
          "error / adjoint error): " + "; ".join(parts28a)
          + f"; {time.perf_counter() - t28:.1f} s", flush=True)

    # ---- 28b: the n=300 LP in f64: gradients of ||x||^2 by mode='vjp'
    # against HiGHS's active-set closed form (1e-6: the gradient after
    # LSQR's rtol 1e-12 is 5e-9 from it on the CPU; 8.8e-7 at n = 1000,
    # the CPU and the card alike), then mode='jvp' (below). n = 1000 took
    # some 88,000 LSQR steps in each mode (169 s of the script on an
    # NVIDIA H100 80GB HBM3 at 700 W, which then ran past 1,050 s); n =
    # 300 takes about 12,700
    t28b = time.perf_counter()
    from scipy.optimize import linprog
    c1, a1, b1 = make_lp(diff_n)
    lp_cone = tt.ConeLayout([tt.rpos(a1.shape[0])])
    t64 = [torch.from_numpy(v).to(dev).double() for v in (c1, a1, b1)]
    a64, b64 = a1.astype(np.float64), b1.astype(np.float64)
    xh = linprog(c1.astype(np.float64), A_ub=a64, b_ub=b64,
                 bounds=(None, None), method="highs").x
    p9 = tt.SolverParam(method="direct", accel="halpern", check_period=20,
                        eps_acc=1e-9, max_iter=400_000)
    solver = tt.make_differentiable_solver(lp_cone, p9,
                                           lsqr_iters=lsqr_iters)
    cv, av, bv = (t.clone().requires_grad_(True) for t in t64)
    for mod in kernels.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x28, y28 = solver(cv, av, bv)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    for k in kernels:
        counts[k] += kernels[k].launches
        kernels[k].launches = 0
    t0 = time.perf_counter()
    gc, ga, gb = torch.autograd.grad((x28 * x28).sum(), (cv, av, bv))
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    steps = solver.stats["lsqr_steps"]
    cnt_b = {k: mod.launches for k, mod in kernels.items()}
    for k in kernels:
        counts[k] += cnt_b[k]
    check(cnt_b["dual_matvec"] == 2 * steps + 1 or not on_card,
          f"backward: {cnt_b['dual_matvec']} dual_matvec launches for "
          f"{steps} LSQR steps (want 2 a step and 1 before)")
    gb_closed, n_b = active_closed_form(a64, b64, xh)
    check(n_b == diff_n, f"HiGHS's vertex has {n_b} active rows, not "
          f"{diff_n}: the closed form needs a nondegenerate vertex")
    err_b = rel2(gb.cpu().numpy(), gb_closed)
    check(all(bool(torch.isfinite(g).all()) for g in (gc, ga, gb)),
          "non-finite gradient")
    print(f"phase 28b LP n={diff_n} f64 (method='direct', Halpern, eps_acc "
          f"1e-9): forward {wall_f:.2f} s; backward (mode='vjp', "
          f"d||x||^2 / dc, dA, db) {wall_b:.3f} s, {steps} LSQR steps "
          f"({1e3 * wall_b / max(steps, 1):.3f} ms a step), "
          f"{cnt_b['dual_matvec'] / max(steps, 1):.3f} dual_matvec "
          f"launches a step; d||x||^2/db {err_b:.1e} from HiGHS's "
          f"active-set closed form ({n_b} active rows, limit 1e-6)",
          flush=True)
    check(err_b <= 1e-6, f"d||x||^2/db {err_b:.3e} from the active-set "
          "closed form (limit 1e-6)")
    wall_p, busy_p, nl_p, top_p = lsqr_profile(
        diff, dproj, solver.cone, t64[0], tt.DenseOp(t64[1]), t64[2],
        x28.detach(), y28.detach(), prof_steps)
    print(f"phase 28b (continued) profile of {prof_steps} LSQR steps: "
          f"{wall_p:.1f} us wall and {busy_p:.1f} us device-busy a step "
          f"({100 * busy_p / wall_p:.1f}% busy), {nl_p:.1f} kernel launches "
          "a step; top kernels (us a step) "
          + ", ".join(f"{k} {t:.1f}" for k, t in top_p), flush=True)
    # mode='jvp' along a random (dc, dA, db) on the same LP against the
    # contraction of mode='vjp''s gradient with that direction. The gate,
    # 1e-7, is set from the readings: the two LSQR solves (each some
    # 90,000 steps at rtol 1e-12 at n = 1000) agreed to 2.7e-8, and a
    # tangent that lacked its dA term reads the share of <grad_A, dA> in
    # the contraction, which the phase prints and requires above 1e-5
    rng = np.random.default_rng(281)
    dirs = [torch.from_numpy(rng.normal(size=t.shape)).to(dev)
            for t in t64]
    solver_j = tt.make_differentiable_solver(lp_cone, p9, mode="jvp",
                                             lsqr_iters=lsqr_iters)
    for mod in kernels.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xj, dxj = torch.func.jvp(lambda *ts: solver_j(*ts)[0], tuple(t64),
                             tuple(dirs))
    torch.cuda.synchronize()
    wall_j = time.perf_counter() - t0
    for k in kernels:
        counts[k] += kernels[k].launches
    parts_j = [float((g * d).sum()) for g, d in zip((gc, ga, gb), dirs)]
    lhs = sum(parts_j)
    rhs = float(2.0 * (xj @ dxj))
    err_j = abs(lhs - rhs) / abs(rhs)
    err_no_da = abs(lhs - parts_j[1] - rhs) / abs(rhs)
    check(err_j <= 1e-7 and err_no_da > 1e-5,
          f"<grad, d> {lhs} vs the JVP's 2 x.dx {rhs} (rel {err_j:.3e}, "
          f"limit 1e-7; without the dA term {err_no_da:.3e}, limit > 1e-5)")
    print(f"phase 28b (continued) LP n={diff_n} f64: mode='jvp' along a "
          f"random (dc, dA, db) against mode='vjp''s gradient: <grad, d> "
          f"{lhs:.12e} vs 2 x.dx {rhs:.12e} (rel {err_j:.1e}, limit 1e-7; "
          f"the contraction without its dA term {err_no_da:.1e}); "
          f"{solver_j.stats['lsqr_steps']} LSQR steps; forward and "
          f"tangent {wall_j:.2f} s; 28b {time.perf_counter() - t28b:.1f} s",
          flush=True)

    # ---- 28c: the JAX package's at-scale instance in f32: the box LP, n
    # = 700, m = 1,400, eps_acc 1e-6 (tests/test_diff.py:135); d||x||^2/dh
    # is 2 on each coordinate's active box row, 0 elsewhere
    t28c = time.perf_counter()
    rng = np.random.default_rng(2)
    cb = rng.normal(size=box_n) + np.sign(rng.normal(size=box_n))
    eye = np.eye(box_n)
    gbox = np.concatenate([eye, -eye])
    hbox = np.ones(2 * box_n)
    box_cone = tt.ConeLayout([tt.rpos(2 * box_n)])
    solver32 = tt.make_differentiable_solver(
        box_cone, tt.SolverParam(max_iter=200_000, eps_acc=1e-6,
                                 method="direct"), lsqr_iters=lsqr_iters)
    cbt, gbt, hbt = (torch.tensor(v, dtype=f32, device=dev)
                     for v in (cb, gbox, hbox))
    hbt.requires_grad_(True)
    for mod in kernels.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xb, _ = solver32(cbt, gbt, hbt)
    (gh,) = torch.autograd.grad((xb * xb).sum(), hbt)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    cnt_c = {k: mod.launches for k, mod in kernels.items()}
    for k in kernels:
        counts[k] += cnt_c[k]
    closed = np.zeros(2 * box_n)
    closed[np.where(cb > 0, box_n + np.arange(box_n), np.arange(box_n))] = 2.0
    got = gh.double().cpu().numpy()
    bad = np.abs(got - closed) > 5e-3 * np.abs(closed) + 1e-4
    check(gh.dtype == f32 and not bad.any(),
          f"box LP f32 gradient: {int(bad.sum())} entries off the closed "
          f"form (rtol 5e-3, atol 1e-4), worst {np.abs(got - closed).max()}")
    print(f"phase 28c box LP n={box_n} m={2 * box_n} f32 (eps_acc 1e-6, "
          f"method='direct'): d||x||^2/dh within rtol 5e-3, atol 1e-4 of "
          f"the closed form (max error {np.abs(got - closed).max():.1e}); "
          f"solve and gradient {wall_c:.2f} s (the JAX test's ceiling 60 s)"
          f", {solver32.stats['lsqr_steps']} LSQR steps, launches {cnt_c}; "
          f"{time.perf_counter() - t28c:.1f} s", flush=True)

    # ---- 28d: a structured A: phase 21's banded box LP (at n = ell_n,
    # ELL_N28D in the script) as a BlockedEllOp in f64. The tiles'
    # cotangent (blocks + blocks_t^T) must be the dense closed form at the
    # same solution and the same LSQR solve w: -(u_y w_x^T - w_y u_x^T),
    # which with u_tau = 1 is u_y c_bar^T - b_bar u_x^T (w_tau cancels),
    # from the same backward's c_bar and b_bar. (A separate dense solve is
    # another LSQR run of about 30,000 steps: its cotangent differed by
    # 4.2e-5 of the largest entry at eps_acc 1e-9.) The gate is an
    # identity of the cotangent's path at a complementary pair (y, s), so
    # the forward stops at eps_acc 1e-6 (at 1e-4 the pair is loose enough
    # to move it past 1e-8)
    t28d = time.perf_counter()
    c21, a21, b21 = make_banded_box_lp(ell_n)
    ell = tt.BlockedEllOp.from_dense(a21.astype(np.float64),
                                     block=(128, 128), device=dev)
    del a21
    solver21 = tt.make_differentiable_solver(
        tt.ConeLayout([tt.rpos(3 * ell_n)]),
        tt.SolverParam(method="direct", accel="halpern", check_period=20,
                       eps_acc=1e-6, max_iter=400_000),
        lsqr_iters=lsqr_iters)
    c21t, b21t = (torch.from_numpy(v.astype(np.float64)).to(dev)
                  .requires_grad_(True) for v in (c21, b21))
    blk = ell.blocks.clone().requires_grad_(True)
    blk_t = ell.blocks_t.clone().requires_grad_(True)
    op21 = tt.BlockedEllOp(blk, ell.cols, blk_t, ell.cols_t, m=3 * ell_n,
                           n=ell_n, bm=128, bn=128)
    for mod in kernels.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x21, y21 = solver21(c21t, op21, b21t)
    torch.cuda.synchronize()
    wall_fwd = time.perf_counter() - t0
    gc21, gb21, g_blk, g_blk_t = torch.autograd.grad(
        (x21 * x21).sum(), (c21t, b21t, blk, blk_t))
    torch.cuda.synchronize()
    wall_bwd = time.perf_counter() - t0 - wall_fwd
    for k in kernels:
        counts[k] += kernels[k].launches
    tiles_g, tiles = ell_tile_cotangent(tt, ell, g_blk, g_blk_t,
                                        3 * ell_n, ell_n, 128)
    dense_g = (torch.outer(y21.detach(), gc21)
               - torch.outer(gb21, x21.detach()))
    scale = float(dense_g.abs().max())
    err_d = float((tiles_g - torch.where(tiles, dense_g, 0.0)).abs().max())
    check(err_d <= 1e-8 * scale, f"ELL tile cotangent {err_d:.3e} from the "
          f"dense closed form (max |cotangent| {scale:.3e}, limit 1e-8 of "
          "it)")
    print(f"phase 28d banded box LP n={ell_n} (A {3 * ell_n}x{ell_n} f64 as "
          f"BlockedEllOp, K={ell.cols.shape[1]}; eps_acc 1e-6): the tiles' "
          f"cotangent (blocks + blocks_t^T) {err_d / scale:.1e} of max "
          f"|cotangent| from the dense closed form u_y c_bar^T - b_bar "
          f"u_x^T at the same solution (limit 1e-8); forward "
          f"{wall_fwd:.2f} s, backward {wall_bwd:.2f} s "
          f"({solver21.stats['lsqr_steps']} LSQR steps); "
          f"{time.perf_counter() - t28d:.1f} s", flush=True)
    return counts


def make_fleet(n_agents, n, m, seed=0):
    """benchmarks/benchmark_admm.py make_fleet (:44-51): random feasible
    per-agent LPs A_i x <= b_i sharing the consensus variable, in
    numpy; returns (c (N, n), a (N, m, n), b (N, m)), each agent's layout
    R+(m)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n_agents, m, n))
    x0 = rng.normal(size=n)
    b = a @ x0 + rng.random((n_agents, m)) + 0.1
    c = rng.normal(size=(n_agents, n))
    return c, a, b


def lanes_summary(res):
    """One line's worth of a batch result: (statuses by name and count,
    iterations median/max)."""
    names = ["RUNNING", "CONVERGED", "EXCESS_ITER", "UNBOUNDED",
             "INFEASIBLE"]
    st = res.status.tolist()
    it = res.iters.tolist()
    by = {names[s]: st.count(s) for s in sorted(set(st))}
    return (" ".join(f"{k} x{v}" for k, v in by.items()),
            f"{int(np.median(it))}/{max(it)}")


class BatchRun:
    """A batch result as ``drive`` prints it (statuses by count and the
    median/max iterations), with the result itself in ``res``."""

    def __init__(self, res):
        self.res = res
        self.status, self.iters = lanes_summary(res)


def same_batch(r1, r2):
    """Whether two batch results are bitwise equal, field by field."""
    return (torch.equal(r1.status, r2.status)
            and torch.equal(r1.iters, r2.iters)
            and torch.equal(r1.x, r2.x) and torch.equal(r1.y, r2.y))


def lanes_vs_single(tt, res, solve_one, lanes):
    """Hold lanes of a batch against their own single solves on the
    card: the same status, x within 1e-3 (1 + ||x||_inf) (f32). Returns
    [(lane, batch iters, single iters, error, bound)]."""
    rows = []
    for i in lanes:
        one = solve_one(i)
        x1 = one.x.double().cpu().numpy()
        xb = res.x[i].double().cpu().numpy()
        err = float(np.abs(xb - x1).max())
        bound = 1e-3 * (1.0 + float(np.abs(x1).max()))
        check(one.status == int(res.status[i]),
              f"lane {i}: status {int(res.status[i])} in the batch, "
              f"{one.status} alone")
        check(err <= bound, f"lane {i}: x differs from its single solve "
              f"by {err:.3e} > {bound:.3e}")
        rows.append((i, int(res.iters[i]), one.iters, err, bound))
    return rows


def fmt_lanes(rows):
    return ", ".join(f"lane {i} {bi}/{si} it (err {e:.1e} <= {b:.1e})"
                     for i, bi, si, e, b in rows)


def halpern_updates(iters, check_period):
    """The updates a Halpern host loop runs for ``iters`` iterations from
    a cold start: ``check_period`` a check plus T(z) at the check."""
    return iters // check_period * (check_period + 1)


def batch_phases(tt, dev, kernels, n29=100, lanes29=8, lanes29b=64,
                 iters29b=8000, lanes29c=32, growth=(64, 50),
                 cov31=(512, 8), singles31=16, mpc=None, burst=128,
                 fleet=(8, 64, 192), admm_outer=8, sweep=None,
                 chunk_cap30=20_000,
                 kept=None):
    """Phases 29-33: lockstep batches on the card (``solve_batch``,
    ``BatchRunner``, ``consensus_admm`` and the batch examples; the sizes
    are arguments only so that the flow can be rehearsed small). Each
    path is driven once, its launch counts set to 0 just before it; all
    of them keep the lockstep host loop (``kernel=''``). Returns the
    kernels' launch counts over these paths; ``kept`` (a dict) receives
    29a-29c's inputs and results for phase 36."""
    from examples_torch import mpc_qp
    from examples_torch import nearestcorr_batch_sdp as nc
    from examples_torch import trajsweep_batch
    from totsu_tpu_torch.runtime.batcher import _tier_chunks
    from totsu_tpu_torch.solver import batched
    f32 = torch.float32
    on_card = dev.type == "cuda"
    counts = {k: 0 for k in kernels}

    def count(runs):
        for r in runs.values():
            for k in kernels:
                counts[k] += r[2][k]
        return runs

    def sync_wall(fn):
        torch.cuda.synchronize() if on_card else None
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize() if on_card else None
        return out, time.perf_counter() - t0

    # ---- phase 29a: bench.py's batch8 cell: 8 lanes of the n=100 LP, c
    # scaled by 1 + 0.1 U per lane, A and b shared as an expanded view
    t29 = time.perf_counter()
    rngb = np.random.default_rng(1)
    c1, g1, h1 = make_lp(n29)
    c29 = torch.tensor(np.stack([c1 * (1.0 + 0.1 * rngb.random(n29))
                                 for _ in range(lanes29)]), dtype=f32,
                       device=dev)
    g29 = torch.tensor(g1, dtype=f32, device=dev)
    h29 = torch.tensor(h1, dtype=f32, device=dev)
    a29 = g29.expand(lanes29, -1, -1)
    b29 = h29.expand(lanes29, -1)
    lay29 = tt.ConeLayout([tt.rpos(g1.shape[0])])
    p29 = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, check_period=20,
                         accel="halpern")

    def batch29():
        return tt.solve_batch(c29, a29, b29, lay29, p29)

    runs = count(drive({f"batch LP n={n29} x {lanes29} lanes": lambda:
                        BatchRun(batch29())}, kernels))
    r29, wall29 = next(iter(runs.values()))[:2]
    r29 = r29.res
    check(bool((r29.status == 1).all()),
          f"29a: statuses {r29.status.tolist()}")
    # the repeat of this batch is phase 30's chunked run, which must equal
    # it bitwise: one more pass over its slowest lane's 86,000 iterations
    # would not fit the time limit
    # the single solves on the megakernel (kernel='mega'): the same
    # algorithm as the host loop at 29b's measured multiple of its rate,
    # where the slowest lane takes some 86,000 iterations
    p29_one = dataclasses.replace(p29, kernel="mega")
    rows29 = lanes_vs_single(
        tt, r29, lambda i: tt.solve_jit(c29[i], g29, h29, lay29, p29_one),
        range(0, lanes29, max(1, lanes29 // 4)))
    it29 = r29.iters.tolist()
    print(f"phase 29a batch LP n={n29} x {lanes29} lanes (A {g1.shape[0]}x"
          f"{n29} f32 shared, expanded; Halpern, eps_acc 1e-3, "
          f"check_period 20): all CONVERGED, iterations median "
          f"{int(np.median(it29))} max {max(it29)}, {wall29:.3f} s; "
          f"against single solves on the "
          f"megakernel (batch/single iterations): {fmt_lanes(rows29)}",
          flush=True)

    # ---- 29b: bench.py's batch64 cell: 64 different n=100 LPs (A 64 x
    # 400 x 100 f32), 8000 iterations at eps_acc 1e-9
    lp64 = [make_lp(n29, seed=100 + i) for i in range(lanes29b)]
    c64, a64, b64 = (torch.tensor(np.stack([x[j] for x in lp64]),
                                  dtype=f32, device=dev) for j in range(3))
    p64 = tt.SolverParam(max_iter=iters29b, eps_acc=1e-9, check_period=20)
    prof_iters = 200

    def run64(graphs):
        # each check period as one CUDA graph (the default on the card),
        # or every update launched eagerly
        batched.CUDA_GRAPHS = graphs
        try:
            res, wall = sync_wall(lambda: tt.solve_batch(c64, a64, b64,
                                                         lay29, p64))
            prof = profile_loop(lambda: tt.solve_batch(
                c64, a64, b64, lay29, dataclasses.replace(
                    p64, max_iter=prof_iters)), prof_iters)
        finally:
            batched.CUDA_GRAPHS = True
        return res, wall, prof

    r64e, wall64e, prof64e = run64(False)
    r64, wall64, prof64 = run64(True)
    check(bool((r64.iters == iters29b).all()),
          f"29b: iterations {sorted(set(r64.iters.tolist()))}")
    check(same_batch(r64, r64e), "29b: the graphed batch differs from the "
          "eager one")
    rate64, rate64e = (lanes29b * iters29b / w for w in (wall64, wall64e))
    us64, busy64, launches64, top64 = prof64e
    single_iters = min(2000, iters29b)
    _, wall_one = sync_wall(lambda: tt.solve_jit(
        c64[0], a64[0], b64[0], lay29, dataclasses.replace(
            p64, max_iter=single_iters)))
    mega_iters = iters29b if on_card else min(200, iters29b)
    _, wall_mega = sync_wall(lambda: tt.solve_jit(
        c64[0], a64[0], b64[0], lay29, dataclasses.replace(
            p64, max_iter=mega_iters, kernel="mega")))
    print(f"phase 29b batch LP n={n29} x {lanes29b} lanes (A {lanes29b}x"
          f"{g1.shape[0]}x{n29} f32, {4 * a64.numel() / 1e6:.1f} MB), "
          f"{iters29b} iterations at eps_acc 1e-9: each check period a CUDA "
          f"graph {wall64:.3f} s, {rate64:.0f} lane-iterations/s (profiled: "
          f"{prof64[0]:.1f} us per iteration, device busy {prof64[1]:.1f} us"
          f", {100 * prof64[1] / prof64[0]:.1f}%), eager {wall64e:.3f} s, "
          f"{rate64e:.0f} lane-iterations/s, bitwise the same; eager profile "
          f"of {prof_iters} lockstep iterations: {launches64:.1f} launches "
          f"and {us64:.1f} us per iteration, device busy {busy64:.1f} us "
          f"({100 * busy64 / us64:.1f}%), top "
          + ", ".join(f"{k} {v:.1f} us" for k, v in top64)
          + f"; one n={n29} LP alone: host loop "
          f"{single_iters / wall_one:.0f} it/s, megakernel "
          f"{mega_iters / wall_mega:.0f} it/s", flush=True)

    # ---- 29c: 32 growth portfolios (seeds 0-31) on the host loop at
    # eps_acc 1e-4: kernel B takes every exp and every pow factor of all
    # lanes in one launch
    s_num, g_n = growth
    grs = [make_growth(s_num, g_n, -2.0, seed=i) for i in range(lanes29c)]
    gr_cone = cone(tt, grs[0][4])
    cg, ag, bg = (torch.tensor(np.stack([g[j] for g in grs]), dtype=f32,
                               device=dev) for j in (1, 2, 3))
    pg = tt.SolverParam(accel="halpern", normalize=True, equil_iters=10,
                        check_period=20, eps_acc=1e-4, max_iter=200_000)

    def batch29c():
        return tt.solve_batch(cg, ag, bg, gr_cone, pg)

    runs = count(drive({f"batch growth portfolio x {lanes29c} lanes":
                        lambda: BatchRun(batch29c())}, kernels))
    rg, wallg, cnt = next(iter(runs.values()))[:3]
    rg = rg.res
    check(bool((rg.status == 1).all()),
          f"29c: statuses {rg.status.tolist()}")
    updates = halpern_updates(int(rg.iters.max()), pg.check_period)
    # each update projects the y block (dual) and the s block (primal),
    # each with one launch for the pow and one for the exp factor of
    # every lane
    check(cnt["cone_proj"] == 4 * updates,
          f"29c: {cnt['cone_proj']} kernel B launches for {updates} "
          f"lockstep updates (want {4 * updates})")
    check(same_batch(rg, batch29c()), "29c: a repeat of the batch differs")
    rowsg = lanes_vs_single(
        tt, rg, lambda i: tt.solve_jit(cg[i], ag[i], bg[i], gr_cone, pg),
        range(0, lanes29c, max(1, lanes29c // 4)))
    itg = rg.iters.tolist()
    print(f"phase 29c batch growth portfolio S={s_num} n={g_n} x "
          f"{lanes29c} lanes (seeds 0-{lanes29c - 1}; Halpern, Ruiz, "
          f"eps_acc 1e-4): all CONVERGED, iterations median "
          f"{int(np.median(itg))} max {max(itg)}, {wallg:.3f} s; kernel B "
          f"launches {cnt['cone_proj']} = 4 x {updates} lockstep updates "
          f"(blocks per launch: {lanes29c * (s_num - 1)} pow, "
          f"{lanes29c * g_n} exp); a repeat bitwise equal; against single "
          f"solves: {fmt_lanes(rowsg)}", flush=True)
    print(f"phase 29 took {time.perf_counter() - t29:.1f} s", flush=True)
    if kept is not None:
        kept.update({
            "29a": (c29, a29, b29, lay29, p29, r29, wall29),
            "29b": (c64, a64, b64, lay29, p64, r64, rate64),
            "29c": (cg, ag, bg, gr_cone, pg, rg)})

    # ---- phase 30: chunking. 29a's batch capped at chunk_cap30
    # iterations in chunks of 200: each lane that 29a converged within the
    # cap is bitwise 29a's, every other lane stops EXCESS_ITER at the cap
    # (29a's slowest lane, some 86,000 lockstep iterations, is not run
    # again); a capped batch leaves every lane EXCESS_ITER
    t30 = time.perf_counter()
    ch30 = tt.solve_batch(c29, a29, b29, lay29, dataclasses.replace(
        p29, max_iter=chunk_cap30), chunk_iters=200)
    done = r29.iters <= chunk_cap30
    check(bool(torch.equal(ch30.status[done], r29.status[done])
               and torch.equal(ch30.iters[done], r29.iters[done])
               and torch.equal(ch30.x[done], r29.x[done])
               and (ch30.status[~done] == 2).all()
               and (ch30.iters[~done] == chunk_cap30).all()),
          f"30: chunked batch differs (iterations {ch30.iters.tolist()} vs "
          f"{r29.iters.tolist()}, cap {chunk_cap30})")
    cap30 = tt.solve_batch(c29, a29, b29, lay29, dataclasses.replace(
        p29, max_iter=100, eps_acc=1e-12))
    check(bool((cap30.iters == 100).all() and (cap30.status == 2).all()),
          f"30: capped batch {cap30.status.tolist()} "
          f"{cap30.iters.tolist()}")
    print(f"phase 30 chunking: 29a's batch capped at {chunk_cap30} in "
          f"chunks of 200: {int(done.sum())} lanes bitwise 29a's (iterations "
          f"{r29.iters[done].tolist()}), {int((~done).sum())} EXCESS_ITER at "
          f"the cap; max_iter=100: every lane "
          f"EXCESS_ITER at 100; {time.perf_counter() - t30:.1f} s",
          flush=True)

    # ---- phase 31: the nearest-correlation batch at B = 512, k = 8 on
    # 'jacobi' (the example's build): one kernel J launch per projection
    # for every lane's PSD block
    t31 = time.perf_counter()
    b31, k31 = cov31
    covs = nc.make_noisy_covs(b31, k31)
    a31, c31, lay31, _, sn31 = nc.build(k31, f32, dev)
    p31 = tt.SolverParam(max_iter=400_000, eps_acc=1e-4, check_period=25)
    bb31 = torch.stack([nc.lane_b(s, k31, sn31, f32, dev) for s in covs])

    def batch31():
        return tt.solve_batch(c31.expand(b31, -1), a31.expand(b31, -1, -1),
                              bb31, lay31, p31)

    runs = count(drive({f"batch nearest correlation {b31} x k={k31}":
                        lambda: BatchRun(batch31())}, kernels))
    r31, wall31, cnt31 = next(iter(runs.values()))[:3]
    r31 = r31.res
    diag_err, eig_min, fro_mean = nc.self_checks(r31, covs, k31, sn31,
                                                 p31.eps_acc)
    lockstep31 = int(r31.iters.max())
    check(cnt31["psd_jacobi"] == 2 * lockstep31,
          f"31: {cnt31['psd_jacobi']} kernel J launches for {lockstep31} "
          f"lockstep updates (want {2 * lockstep31})")
    fro31 = []
    for i in range(singles31):
        one = tt.solve_jit(c31, a31, bb31[i], lay31, p31)
        check(one.status == int(r31.status[i]),
              f"31: lane {i} status {int(r31.status[i])}, alone "
              f"{one.status}")
        d = float(torch.linalg.vector_norm(
            (one.x[:sn31] - r31.x[i, :sn31]).double()))
        check(d <= 1e-3, f"31: lane {i}: ||X - X_alone||_F = {d:.3e}")
        fro31.append(d)
    print(f"phase 31 nearest correlation {b31} x k={k31} (A {a31.shape[0]}"
          f"x{a31.shape[1]} shared, psd 'jacobi', eps_acc 1e-4, "
          f"check_period 25): all CONVERGED, iterations median/max "
          f"{lanes_summary(r31)[1]}, {wall31:.3f} s, "
          f"{b31 * lockstep31 / wall31:.0f} lane-iterations/s; kernel J "
          f"launches {cnt31['psd_jacobi']} = 2 x {lockstep31} projections "
          f"of {b31} blocks; self-checks diag err {diag_err:.1e}, min "
          f"eigenvalue {eig_min:.1e}, mean ||X - S||_F {fro_mean:.3f}; "
          f"{singles31} lanes alone: same status, max ||X - X_alone||_F "
          f"{max(fro31):.1e}; {time.perf_counter() - t31:.1f} s",
          flush=True)

    # ---- phase 32: BatchRunner. The MPC fleet at the example's defaults
    # (warm and cold), then a burst of 128 tick QPs through submit
    t32 = time.perf_counter()
    mpc_kw = dict(mpc or {})
    try:
        (warm32, cold32), wall32 = sync_wall(lambda: (
            mpc_qp.main(cpu=not on_card, **mpc_kw),
            mpc_qp.main(cpu=not on_card, use_warm=False, **mpc_kw)))
    except AssertionError as exc:
        fail(f"32: the MPC example's checks failed: {exc}")
    check(sum(warm32) < sum(cold32),
          f"32: warm total {sum(warm32)} not below cold {sum(cold32)}")
    dtype32 = f32 if on_card else torch.float64
    rng32, states32, targets32 = mpc_qp.fleet(burst, 32)
    probs32 = [mpc_qp.tick_problem(states32[i], targets32[i], 8, 0.25, 1e-2,
                                   4.0, dtype32) for i in range(burst)]
    runner = tt.BatchRunner(mpc_qp.tick_param(), device=dev)
    sizes32 = []
    real_map = runner.map

    def recording_map(problems, warm_starts=None):
        sizes32.append(len(problems))
        return real_map(problems, warm_starts)

    runner.map = recording_map
    ref32 = real_map(probs32)   # prepares the tier's solver, as a server
    t0 = time.perf_counter()
    futs = [runner.submit(p, flush_ms=200.0, max_pending=burst)
            for p in probs32]
    got32 = [f.result(timeout=600) for f in futs]
    wall_burst = time.perf_counter() - t0
    tiers32 = [t for sz in sizes32 for t in _tier_chunks(sz)]
    check(sizes32 == [burst] and tiers32 == _tier_chunks(burst),
          f"32: the burst ran as batches {sizes32}, tiers {tiers32}")
    check(all(r.status == 1 for r in got32),
          f"32: statuses {sorted(set(r.status for r in got32))}")
    check(all(a.status == b.status and a.iters == b.iters
              and torch.equal(a.x, b.x) for a, b in zip(got32, ref32)),
          "32: submit's results differ from map's")
    fleet32 = {"n_vehicles": 6, "h_horizon": 8, "ticks": 18, **mpc_kw}
    print(f"phase 32 BatchRunner: MPC fleet ({fleet32['n_vehicles']} "
          f"vehicles, H = {fleet32['h_horizon']}, {fleet32['ticks']} ticks, "
          f"direct + Halpern, warm starts) every tick CONVERGED, final "
          f"distance < 0.5; iterations warm {sum(warm32)} (per tick "
          f"{warm32}) vs cold {sum(cold32)}, {wall32:.2f} s both; burst of "
          f"{burst} tick QPs through submit: one drain, tiers {tiers32}, "
          f"every future resolved, equal to map's; {wall_burst:.3f} s, "
          f"{burst / wall_burst:.0f} requests/s; "
          f"{time.perf_counter() - t32:.1f} s", flush=True)

    # ---- phase 33: consensus ADMM on benchmark_admm.py's fleet, held
    # against the joint LP on the card; the trajectory sweep at its
    # defaults
    t33 = time.perf_counter()
    n_ag, n_x, m_ag = fleet
    cf, af, bf = (torch.tensor(x, dtype=f32, device=dev)
                  for x in make_fleet(n_ag, n_x, m_ag))
    lay_ag = tt.ConeLayout([tt.rpos(m_ag)])
    p_ag = tt.SolverParam(max_iter=20_000, eps_acc=1e-3, check_period=20)
    joint = tt.solve_jit(cf.sum(0), af.reshape(-1, n_x), bf.reshape(-1),
                         tt.ConeLayout([tt.rpos(n_ag * m_ag)]),
                         tt.SolverParam(max_iter=200_000, eps_acc=1e-5,
                                        accel="halpern", check_period=20,
                                        kernel="auto"))
    check(joint.converged, f"33: the joint LP's status {joint.status}")
    xj = joint.x.double().cpu().numpy()
    line33, z33 = [], []
    for rps in (1, 4):
        res, wall = sync_wall(lambda: tt.consensus_admm(
            cf, af, bf, lay_ag, max_outer=admm_outer, tol=0.0,
            param=p_ag, rounds_per_sync=rps))
        z33.append(res.z)
        # consensus ADMM closes its residuals at about 1/k on this fleet
        # (8 rounds leave pri/dual at 0.33/0.10 on the card), so the gate
        # holds z within 5% of the joint solution's scale after
        # ``admm_outer`` rounds, not at the tolerance (the card reads
        # 0.087 against the bound's 0.175 after 8)
        err = float(np.abs(res.z - xj).max())
        bound = 5e-2 * (1.0 + float(np.abs(xj).max()))
        check(err <= bound and bool(np.isfinite(res.z).all()),
              f"33: ADMM rounds_per_sync={rps} after {res.outer_iters} "
              f"rounds: |z - x_joint|_inf {err:.3e} > {bound:.3e}")
        line33.append(f"rounds_per_sync {rps}: {res.outer_iters} rounds, "
                      f"{wall:.2f} s, pri/dual {res.pri_res:.2e}/"
                      f"{res.dual_res:.2e}, |z - x_joint|_inf {err:.2e} "
                      f"(bound {bound:.2e}), unconverged-subsolve rounds "
                      f"{res.rounds_with_unconverged_subsolves}")
    # the sweep at its defaults but the cap of 140, whose lane alone takes
    # 230,918 lockstep iterations (`examples_torch/trajsweep_batch.py
    # --cpu`, f64): minutes of host loop
    sweep_kw = sweep or {"caps": (170.0, 200.0, 300.0)}
    (objs33, wall_sweep) = sync_wall(lambda: trajsweep_batch.main(
        cpu=not on_card, **sweep_kw))
    print(f"phase 33 consensus ADMM {n_ag} agents n={n_x} m={m_ag} "
          f"(benchmark_admm.py's subsolves: eps_acc 1e-3, check_period "
          f"20; {admm_outer} rounds) against the joint LP "
          f"({joint.iters} iterations): " + "; ".join(line33)
          + f"; max |z(1) - z(4)| {float(np.abs(z33[0] - z33[1]).max()):.1e}"
          f"; trajectory sweep (t_cap {sweep_kw.get('t_cap', 12)}, caps "
          f"{sweep_kw.get('caps')}): "
          "all CONVERGED, objectives "
          + ",".join(f"{o:.1f}" for o in objs33)
          + f" in {wall_sweep:.2f} s; "
          f"{time.perf_counter() - t33:.1f} s", flush=True)
    return counts


# ---- phases 34-35: distribution over torch.distributed ranks and the
# native engine

class RunnerRun:
    """A list of single results (``BatchRunner.map``) as ``drive`` prints
    it, with the list itself in ``res``."""

    def __init__(self, results):
        self.res = results
        st = [r.status for r in results]
        it = [r.iters for r in results]
        self.status = " ".join(f"{s} x{st.count(s)}" for s in sorted(set(st)))
        self.iters = f"{int(np.median(it))}/{max(it)}"


def _lane_args(args, i):
    """Lane ``i`` of the batched megakernel's positional inputs, each a
    one-lane batch (tuples of tensors sliced member by member)."""
    def one(x):
        if isinstance(x, tuple):
            return tuple(one(t) for t in x)
        return x[i:i + 1] if isinstance(x, torch.Tensor) else x
    return tuple(one(x) for x in args)


def _lane_kwargs(kwargs, i):
    return {k: (v[i:i + 1] if isinstance(v, torch.Tensor) else v)
            for k, v in kwargs.items()}


def _same_or(x, y, err):
    """'bitwise' when x equals y bit for bit, else the error."""
    return "bitwise" if torch.equal(x, y) else f"{err:.1e}"


def _x_over_tau(out):
    """x / tau of each lane of a batched megakernel result."""
    return out[0][0] / out[0][3][:, None]


def batch_mega_phases(tt, dev, kernels, kept, lanes36d=512, n36d=50,
                      iters36d=2000, burst36=64, record_iters=40,
                      sample=(0, 21, 42, 63)):
    """Phase 36: the batched megakernel (``solve_batch(kernel='mega')``,
    every lane in one launch) on phase 29's batches (``kept``, from
    :func:`batch_phases`), on a batch wider than one resident wave, and
    under ``profile='fast'`` and a ``BatchRunner`` burst with
    ``kernel='auto'``. Each path is driven once, its launch counts set to
    0 just before it; the comparisons with single-lane solves and the
    plain version run outside them. The sizes are arguments only so that
    the flow can be rehearsed small. Returns (the kernels' launch counts
    over these paths, the kernels record's ``megakernel_batch`` row)."""
    mk = kernels["megakernel"]
    on_card = dev.type == "cuda"
    f32 = torch.float32
    counts = {k: 0 for k in kernels}
    t36 = time.perf_counter()

    def count(runs):
        for r in runs.values():
            for k in kernels:
                counts[k] += r[2][k]
        return runs

    def one_launch(what, cnt, launches=1):
        # on the card every lane runs in the plan's one launch of the
        # batched kernel, and nothing else launches (a single solve's
        # megakernel launch neither); on the CPU the plain version counts
        # nothing
        if on_card:
            check(cnt["megakernel_batch"] == launches and sum(cnt.values())
                  == launches, f"{what}: launches {cnt} (want {launches} "
                  f"batched megakernel launch(es))")

    def plan_of(lanes, m, n, cone_):
        if on_card:
            return mk.device_plan_batch(lanes, m, n, cone_, dev)[0]
        return mk.plan_batch(lanes, m, n, mk.cone_tables(cone_), 132,
                             232_448)

    def x_err(x, ref):
        """Each lane's max |x - ref| over 1 + |ref|_inf, the largest."""
        return float(((x - ref).abs().amax(-1)
                      / (1.0 + ref.abs().amax(-1))).max())

    # ---- 36a: 29b's 64 n=100 LPs at 8,000 iterations on the kernel
    c64, a64, b64, lay, p64, r64, rate64 = kept["29b"]
    lanes, m, n = a64.shape
    iters = p64.max_iter
    pm = dataclasses.replace(p64, kernel="mega")
    recorded = []
    real_batch = mk.solve_mega_batch

    def recording(*args, **kwargs):
        out = real_batch(*args, **kwargs)
        recorded.append((args, kwargs, out))
        return out

    mk.solve_mega_batch = recording
    try:
        runs = count(drive({
            f"batch LP n={n} x {lanes} lanes, kernel='mega'":
                lambda: BatchRun(tt.solve_batch(c64, a64, b64, lay, pm))},
            kernels))
    finally:
        mk.solve_mega_batch = real_batch
    r36, wall36, cnt36 = next(iter(runs.values()))[:3]
    r36 = r36.res
    one_launch("36a", cnt36)
    check(r36.diag["route"] == "mega" and len(recorded) == 1,
          f"36a: route {r36.diag['route']}, {len(recorded)} batched calls")
    check(bool((r36.iters == iters).all()),
          f"36a: iterations {sorted(set(r36.iters.tolist()))}")
    check(torch.equal(r36.status, r64.status),
          f"36a: statuses {r36.status.tolist()} against the host loop's "
          f"{r64.status.tolist()}")
    err36 = x_err(r36.x, r64.x)
    check(err36 <= 1e-5, f"36a: x {err36:.3e} from 29b's graphed batch")
    bp = plan_of(lanes, m, n, lay)
    args, kwargs, out = recorded[0]
    # each sampled lane alone: one launch of the kernel on that lane's
    # inputs at the batch's G (bitwise: the kernel against itself), and
    # solve_jit(kernel='mega') at that G (its setup's reductions run on
    # one lane's shapes, so the two agree to f32 roundoff)
    saved = dict(mk.PLAN_OVERRIDES)
    mk.PLAN_OVERRIDES["grid"] = bp.grid
    rows = []
    try:
        for i in [j for j in sample if j < lanes]:
            u1, v1, k1, s1, _ = mk.solve_mega_batch(
                *_lane_args(args, i), **_lane_kwargs(kwargs, i))
            same = (all(torch.equal(a_[0], b_[i]) for a_, b_
                        in zip(u1 + v1, out[0] + out[1]))
                    and int(k1[0]) == int(out[2][i])
                    and int(s1[0]) == int(out[3][i]))
            check(same, f"36a: lane {i} alone on the kernel at G="
                  f"{bp.grid} differs from the batch's lane")
            alone = tt.solve_jit(c64[i], a64[i], b64[i], lay, pm)
            d = x_err(alone.x[None], r36.x[i:i + 1])
            check(alone.status == int(r36.status[i])
                  and alone.iters == int(r36.iters[i]) and d <= 1e-4,
                  f"36a: lane {i} through solve_jit: status {alone.status}"
                  f", {alone.iters} iterations, x {d:.3e} away")
            rows.append(f"lane {i} bitwise, solve_jit "
                        + _same_or(alone.x, r36.x[i], d))
    finally:
        mk.PLAN_OVERRIDES.clear()
        mk.PLAN_OVERRIDES.update(saved)
    # the kernel against its plain version (the host loop lane by lane)
    # on 36a's inputs at record_iters iterations: x/tau, times, bound
    short = dict(kwargs, max_iter=record_iters)
    k_s, out_k = sync_time(lambda: mk.solve_mega_batch(*args, **short), 3)
    p_s, out_p = sync_time(lambda: mk.solve_mega_batch_plain(*args, **short),
                           1)
    xk, xp = _x_over_tau(out_k), _x_over_tau(out_p)
    err_plain = float((xk - xp).abs().max())
    # each lane's error relative to its own |x/tau|_inf, with no floor: a
    # lane that read a neighbour's data would be off by its whole size
    xp_lane = xp.abs().amax(-1)
    rel_plain = float(((xk - xp).abs().amax(-1) / xp_lane).max())
    check(torch.equal(out_k[3], out_p[3]) and rel_plain <= 1e-5,
          f"36a: kernel against plain: statuses {out_k[3].tolist()} / "
          f"{out_p[3].tolist()}, x/tau {err_plain:.3e} ({rel_plain:.3e} of "
          f"a lane's |x/tau|_inf)")
    a_bytes = 4 * m * n * (1 if args[0].stride(0) == 0 else lanes)
    bnd = bound_ms(a_bytes, 8 * m * n * int(out_k[2].sum()))
    rate36 = lanes * iters / wall36
    print(f"phase 36a batched megakernel, 29b's batch LP n={n} x {lanes} "
          f"lanes, {iters} iterations at eps_acc 1e-9: {wall36:.3f} s, "
          f"{rate36:.0f} lane-iterations/s (29b's graphed host loop "
          f"{rate64:.0f}, {rate36 / rate64:.2f}x), launches "
          f"{cnt36['megakernel_batch']}; plan {bp.describe()}; statuses the "
          f"host loop's, x {err36:.2e} from it; {'; '.join(rows)}; kernel "
          f"against plain at {record_iters} iterations: "
          f"{1e3 * k_s:.2f} / {1e3 * p_s:.1f} ms, x/tau {err_plain:.2e} "
          f"(at most {rel_plain:.2e} of a lane's |x/tau|_inf, which runs "
          f"{float(xp_lane.min()):.3g}-{float(xp_lane.max()):.3g}), "
          f"bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)

    # ---- 36b: 29a's batch8 (A expanded, Halpern) to convergence
    c29, a29, b29, lay29, p29, r29, wall29 = kept["29a"]
    runs = count(drive({
        f"batch LP n={n} x {a29.shape[0]} lanes Halpern, kernel='mega'":
            lambda: BatchRun(tt.solve_batch(
                c29, a29, b29, lay29, dataclasses.replace(p29,
                                                          kernel="mega")))},
        kernels))
    r36b, wall36b, cnt = next(iter(runs.values()))[:3]
    r36b = r36b.res
    one_launch("36b", cnt)
    check(bool((r36b.status == 1).all()),
          f"36b: statuses {r36b.status.tolist()}")
    bpb = plan_of(a29.shape[0], a29.shape[1], n, lay29)
    print(f"phase 36b batched megakernel, 29a's batch8 (A expanded, "
          f"Halpern, eps_acc 1e-3): all CONVERGED in {wall36b:.3f} s "
          f"(29a's host loop {wall29:.3f} s), iterations (kernel/host loop)"
          f" " + ", ".join(f"{a_}/{b_}" for a_, b_ in zip(
              r36b.iters.tolist(), r29.iters.tolist()))
          + f"; launches {cnt['megakernel_batch']}; plan {bpb.describe()}",
          flush=True)

    # ---- 36c: 29c's 32 growth portfolios (mega_kernel<true>)
    cg, ag, bg, gr_cone, pg, rg = kept["29c"]
    runs = count(drive({
        f"batch growth portfolio x {ag.shape[0]} lanes, kernel='mega'":
            lambda: BatchRun(tt.solve_batch(
                cg, ag, bg, gr_cone, dataclasses.replace(pg,
                                                         kernel="mega")))},
        kernels))
    r36c, wall36c, cnt = next(iter(runs.values()))[:3]
    r36c = r36c.res
    one_launch("36c", cnt)
    obj_k = (cg.double() * r36c.x.double()).sum(-1)
    obj_h = (cg.double() * rg.x.double()).sum(-1)
    rel = float(((obj_k - obj_h).abs() / obj_h.abs().clamp(min=1.0)).max())
    check(bool((r36c.status == 1).all()) and rel <= 5e-3,
          f"36c: statuses {r36c.status.tolist()}, objectives {rel:.3e} "
          f"from 29c's")
    bpc = plan_of(ag.shape[0], ag.shape[1], ag.shape[2], gr_cone)
    print(f"phase 36c batched megakernel, 29c's {ag.shape[0]} growth "
          f"portfolios (exp/pow, mega_kernel<true>): all CONVERGED in "
          f"{wall36c:.3f} s, iterations median "
          f"{int(r36c.iters.median())} max {int(r36c.iters.max())} (29c's "
          f"host loop: median {int(rg.iters.median())} max "
          f"{int(rg.iters.max())}), objectives within {rel:.2e} of 29c's; "
          f"launches {cnt['megakernel_batch']}; plan {bpc.describe()}",
          flush=True)

    # ---- 36d: lanes36d n=50 QPs (seeds 0..) at fixed iterations: more
    # lanes than one wave of CTAs holds, one CTA a lane
    qps = [tt.problems.qp(*[torch.from_numpy(v) for v in make_qp(n36d, i)],
                          device="cpu") for i in range(lanes36d)]
    qcone = qps[0].cone
    cq, aq, bq = (torch.stack(ts).to(dev, f32) for ts in (
        [q.c for q in qps], [q.a.a for q in qps], [q.b for q in qps]))
    pq = tt.SolverParam(max_iter=iters36d, eps_acc=1e-12, check_period=20,
                        kernel="mega")
    runs = count(drive({
        f"batch QP n={n36d} x {lanes36d} lanes, kernel='mega'":
            lambda: BatchRun(tt.solve_batch(cq, aq, bq, qcone, pq))},
        kernels))
    r36d, wall36d, cnt = next(iter(runs.values()))[:3]
    r36d = r36d.res
    one_launch("36d", cnt)
    check(bool((r36d.iters == iters36d).all() and (r36d.status == 2).all()),
          f"36d: statuses {sorted(set(r36d.status.tolist()))}, iterations "
          f"{sorted(set(r36d.iters.tolist()))}")
    bpd = plan_of(lanes36d, aq.shape[1], aq.shape[2], qcone)
    rows = []
    for i in sorted({0, lanes36d // 2, lanes36d - 1}):
        alone = tt.solve_jit(cq[i], aq[i], bq[i], qcone, pq)
        d = x_err(alone.x[None], r36d.x[i:i + 1])
        check(alone.iters == iters36d and d <= 1e-4,
              f"36d: lane {i} alone: {alone.iters} iterations, x {d:.3e} "
              f"away")
        rows.append(f"lane {i} " + _same_or(alone.x, r36d.x[i], d))
    print(f"phase 36d batched megakernel, {lanes36d} QPs n={n36d} (A "
          f"{aq.shape[1]}x{aq.shape[2]} each), {iters36d} iterations: "
          f"{wall36d:.3f} s, {lanes36d * iters36d / wall36d:.0f} "
          f"lane-iterations/s; launches {cnt['megakernel_batch']}; plan "
          f"{bpd.describe()}; against single-lane megakernel solves: "
          + ", ".join(rows), flush=True)

    # ---- 36e: profile='fast' on 29a's batch (mega-first: the kernel via
    # kernel='auto'), and a BatchRunner burst with kernel='auto'
    pf = tt.SolverParam(profile="fast", max_iter=200_000, eps_acc=1e-3)
    runner = tt.BatchRunner(tt.SolverParam(max_iter=iters36d,
                                           eps_acc=1e-12, check_period=20,
                                           kernel="auto"), device=dev)
    burst = [(cq[i], aq[i], bq[i], qcone) for i in range(burst36)]
    runs = count(drive({
        f"batch LP x {a29.shape[0]} lanes, profile='fast'":
            lambda: BatchRun(tt.solve_batch(c29, a29, b29, lay29, pf)),
        f"BatchRunner burst of {burst36} QPs, kernel='auto'":
            lambda: RunnerRun(runner.map(burst))}, kernels))
    (r_fast, _, cnt_fast, _), (r_run, wall_run, cnt_run, _) = runs.values()
    want = "mega" if on_card else "loop"
    routes = sorted({r for v in runner.routes.values() for r in v})
    tiers = len(runner.routes)
    check(r_fast.res.diag["route"] == want and routes == [want]
          and bool((r_fast.res.status == 1).all()),
          f"36e: fast profile route {r_fast.res.diag['route']}, statuses "
          f"{r_fast.res.status.tolist()}; runner routes {routes}")
    one_launch("36e fast profile", cnt_fast)
    one_launch("36e BatchRunner", cnt_run, tiers)
    print(f"phase 36e kernel='auto': profile='fast' on 29a's batch ran on "
          f"the {r_fast.res.diag['route']} route, launches "
          f"{cnt_fast['megakernel_batch']}, iterations "
          f"{r_fast.res.iters.tolist()}; a BatchRunner burst of {burst36} "
          f"QPs in {tiers} tier(s) on the {routes} route, launches "
          f"{cnt_run['megakernel_batch']}, {wall_run:.3f} s; phase 36 "
          f"took {time.perf_counter() - t36:.1f} s", flush=True)
    row = {"name": "megakernel_batch", "route": "cuda",
           "source": "totsu_tpu_torch/csrc/megakernel.cu",
           "replaces": "totsu_tpu/ops/pallas/megakernel.py:184",
           "launches": counts["megakernel_batch"],
           "max_abs_err": err_plain,
           "ms": 1e3 * k_s, "plain_ms": 1e3 * p_s, "bound_ms": bnd[0],
           "bound_by": bnd[1], "library_ms": None, "plan": bp.describe()}
    return counts, row


#: phase 37's examples, at tests/test_examples.py's sizes
EXAMPLES37 = (
    ("l1reg_lp", dict(l=10)), ("svm_qp", dict(l=20)),
    ("trajplan_qcqp", dict(t_cap=12, a_cap=300.0)),
    ("toruscompl_socp", dict(x_num=5, y_num=4)),
    ("partitioning_sdp", dict(x_num=4, y_num=3)),
    ("imgnr_udef", dict(w=24, h=24, ratio=0.01)),
    ("leastsq_qp", dict(mrows=30, n=8)),
    ("growthport_powexp", dict(n=4, s_num=4, h_budget=-1.0)),
    ("boxdesign_gp", {}), ("logreg_expcone", dict(m=24, n=6)),
    ("fit_qp", dict(n=3, n_obs=3, steps=80)))


def examples_phase(dev, kernels, examples=EXAMPLES37):
    """Phase 37: each example's ``main`` on ``dev`` (the card in f32, the
    CPU in f64 when rehearsed) at tests/test_examples.py's sizes; a
    self-check that fails fails the phase. Returns the launch counts."""
    import importlib
    on_card = dev.type == "cuda"
    counts = {k: 0 for k in kernels}
    rows = []
    t37 = time.perf_counter()
    for name, kw in examples:
        mod = importlib.import_module(f"examples_torch.{name}")
        for k in kernels.values():
            k.launches = 0
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            mod.main(**kw, cpu=not on_card)
        except AssertionError as exc:
            fail(f"37: {name}'s self-check failed: {exc!r}")
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cnt = {k: m.launches for k, m in kernels.items()}
        for k in kernels:
            counts[k] += cnt[k]
        rows.append(f"{name} {wall:.2f} s "
                    + (", ".join(f"{k} {v}" for k, v in cnt.items() if v)
                       or "no kernel launch"))
    print(f"phase 37 the examples' mains at tests/test_examples.py's sizes "
          f"({'f32 on the card' if on_card else 'f64 on the CPU'}), every "
          f"self-check passed: " + "; ".join(rows) + f"; phase 37 took "
          f"{time.perf_counter() - t37:.1f} s", flush=True)
    return counts


#: phase 34a's parameters (the main path's Halpern profile, at a fixed
#: count: eps_acc far below what the count reaches)
P34A = dict(accel="halpern", normalize=True, equil_iters=10,
            check_period=20, eps_acc=1e-12)
#: phase 34b's (plain pdhg at a fixed count), 34c's (phase 29b's batch64)
#: and 34d's (phase 33's subsolves)
P34B = dict(eps_acc=1e-12, check_period=20)
P34C = dict(eps_acc=1e-9, check_period=20)
P34D = dict(max_iter=20_000, eps_acc=1e-3, check_period=20)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    """(fn(), wall seconds), the device synchronized on both sides."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def tiles_box_ell(tt, n, dev, bm=128):
    """``make_tiles_lp``'s [band; I; -I] as one BlockedEllOp (m = 3n; the
    box rows as identity tiles), the shape ``shard_blocked_ell_problem``
    takes; returns (op, b, c)."""
    tiles, b, c = make_tiles_lp(n, bm)
    nb = n // bm
    eye = np.eye(bm, dtype=np.float32)
    for i in range(nb):
        tiles[(nb + i, i)] = eye
        tiles[(2 * nb + i, i)] = -eye
    op = tt.BlockedEllOp.from_tiles(tiles, m=3 * n, n=n, block=(bm, bm),
                                    device=dev)
    return op, b, c


def dist_data(tt, dev, cfg, what):
    """Phase 34's problems, built alike in the main process and in every
    rank: 'dense' (c, A, b, layout) of bench.make_lp, 'ell' the from-tiles
    LP, 'batch' 29b's batch64, 'admm' 33's fleet in f64."""
    f32, f64 = torch.float32, torch.float64
    if what == "dense":
        c, g, h = make_lp(cfg["lp_n"])
        return (torch.tensor(c, dtype=f64, device=dev),
                torch.tensor(g, dtype=f64, device=dev),
                torch.tensor(h, dtype=f64, device=dev),
                tt.ConeLayout([tt.rpos(g.shape[0])]))
    if what == "ell":
        op, b, c = tiles_box_ell(tt, cfg["ell_n"], dev)
        return (torch.from_numpy(c).to(dev), op, torch.from_numpy(b).to(dev),
                tt.ConeLayout([tt.rpos(op.m)]))
    if what == "batch":
        lps = [make_lp(cfg["n34c"], seed=100 + i)
               for i in range(cfg["lanes34c"])]
        c, a, b = (torch.tensor(np.stack([x[j] for x in lps]), dtype=f32,
                                device=dev) for j in range(3))
        return c, a, b, tt.ConeLayout([tt.rpos(a.shape[1])])
    c, a, b = (torch.tensor(x, dtype=f64, device=dev)
               for x in make_fleet(*cfg["fleet"]))
    return c, a, b, tt.ConeLayout([tt.rpos(cfg["fleet"][2])])


def _dense_runs(tt, dev, cfg, solve):
    """34a's two solves through ``solve(problem, param)``: f64 at
    ``dense_iters``, then f32 at ``f32_iters`` for the times (after a
    short warm-up). Returns {dtype name: (status, iters, x, wall,
    dual_matvec launches)}."""
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    c, a, b, lay = dist_data(tt, dev, cfg, "dense")
    out = {}
    for dtype, iters in ((torch.float64, cfg["dense_iters"]),
                         (torch.float32, cfg["f32_iters"])):
        prob = tt.ConicProblem(c.to(dtype), tt.DenseOp(a.to(dtype)),
                               b.to(dtype), lay)
        param = tt.SolverParam(max_iter=iters, **P34A)
        if dtype == torch.float32:
            solve(prob, tt.SolverParam(max_iter=40, **P34A))  # a warm-up
        dm.launches = 0
        res, wall = _timed(dev, lambda: solve(prob, param))
        out[str(dtype).split(".")[-1]] = (
            res.status, res.iters, res.x.double().cpu().numpy(), wall,
            dm.launches)
    return out


def _rank_dense(tt, dev, cfg, mesh):
    from totsu_tpu_torch.parallel import _collectives as coll
    from totsu_tpu_torch.parallel import shard_dense_problem
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm

    counts = {}

    def solve(prob, param):
        sharded = shard_dense_problem(prob, mesh)
        coll.reset()
        res = sharded.solve_jit(param)
        counts[str(prob.c.dtype)] = dict(coll.counts)
        counts["op"] = sharded.a
        return res

    runs = _dense_runs(tt, dev, cfg, solve)
    op = counts.pop("op")
    m, n = op.shape
    # one dual_matvec alone: its collectives and kernel launches
    u = torch.ones(n, dtype=torch.float32, device=dev)
    v = torch.ones(m, dtype=torch.float32, device=dev)
    coll.reset()
    dm.launches = 0
    op.dual_matvec(u, v)
    one = (dict(coll.counts), dm.launches)
    # the time of one collective: the n-sum of the f32 update, back to back
    reps = cfg["coll_reps"]
    _, wall = _timed(dev, lambda: [coll.reduce_sum(u, op.group)
                                   for _ in range(reps)])
    return {"runs": runs, "counts": counts, "one": one,
            "us_per_collective": 1e6 * wall / reps,
            "rows": op.local.shape[0]}


def _rank_ell(tt, dev, cfg, mesh):
    from totsu_tpu_torch.parallel import _collectives as coll
    from totsu_tpu_torch.parallel import shard_blocked_ell_problem
    c, op, b, lay = dist_data(tt, dev, cfg, "ell")
    sharded = shard_blocked_ell_problem(tt.ConicProblem(c, op, b, lay), mesh)
    del op
    param = tt.SolverParam(max_iter=cfg["ell_iters"], **P34B)
    coll.reset()
    res, wall = _timed(dev, lambda: sharded.solve_jit(param))
    return {"status": res.status, "iters": res.iters,
            "x": res.x.cpu().numpy(), "wall": wall,
            "counts": dict(coll.counts),
            "tiles": tuple(sharded.a.blocks.shape)}


def _rank_batch(tt, dev, cfg, mesh):
    from totsu_tpu_torch.parallel import _collectives as coll
    c, a, b, lay = dist_data(tt, dev, cfg, "batch")
    param = tt.SolverParam(max_iter=cfg["iters34c"], **P34C)
    tt.solve_batch(c, a, b, lay, tt.SolverParam(max_iter=40, **P34C),
                   mesh=mesh)           # a warm-up (the CUDA graph)
    coll.reset()
    res, wall = _timed(dev, lambda: tt.solve_batch(c, a, b, lay, param,
                                                   mesh=mesh))
    return {"status": res.status.cpu().numpy(),
            "iters": res.iters.cpu().numpy(), "x": res.x.cpu().numpy(),
            "wall": wall, "counts": dict(coll.counts)}


def _rank_admm(tt, dev, cfg, mesh):
    from totsu_tpu_torch.parallel import _collectives as coll
    c, a, b, lay = dist_data(tt, dev, cfg, "admm")
    coll.reset()
    res, wall = _timed(dev, lambda: tt.consensus_admm(
        c, a, b, lay, max_outer=cfg["admm_rounds"], tol=0.0,
        param=tt.SolverParam(**P34D), mesh=mesh))
    return {"z": res.z, "rounds": res.outer_iters, "wall": wall,
            "counts": dict(coll.counts)}


_RANK_SCENARIOS = {"dense": ("row", _rank_dense), "ell": ("row", _rank_ell),
                   "batch": ("batch", _rank_batch),
                   "admm": ("batch", _rank_admm)}


def dist_rank(rank, world, port, backend, device_type, cfg, scenarios, out):
    """One rank of phase 34, in a process of its own: it joins the group
    through ``multihost.init`` (a tcp coordinator), runs ``scenarios`` on
    meshes over the whole world and sends back their results."""
    import traceback
    import torch.distributed as dist
    try:
        import totsu_tpu_torch as tt
        from totsu_tpu_torch.parallel import make_mesh, multihost
        multihost.init(coordinator_address=f"127.0.0.1:{port}",
                       num_processes=world, process_id=rank,
                       backend=backend)
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dev = torch.device(device_type, 0) if device_type == "cuda" \
            else torch.device("cpu")
        rec = {"multihost": multihost.is_multihost(),
               "backend": dist.get_backend()}
        for name in scenarios:
            axis, fn = _RANK_SCENARIOS[name]
            mesh = make_mesh(**{axis: world}, devices=device_type)
            rec[name] = fn(tt, dev, cfg, mesh)
        out.put((rank, True, rec))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(nranks, backend, device_type, cfg, scenarios, timeout):
    """Spawn ``nranks`` processes of :func:`dist_rank`, wait at most
    ``timeout`` s for their results, stop every one of them; a rank that
    fails, or a world past its time, fails the phase. A port lost between
    the probe and the bind is tried once more on a fresh one."""
    import queue
    import socket
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    for attempt in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        out = ctx.Queue()
        procs = [ctx.Process(target=dist_rank, args=(
            r, nranks, port, backend, device_type, cfg, scenarios, out),
            daemon=True) for r in range(nranks)]
        for p in procs:
            p.start()
        results, errors = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) + len(errors) < nranks:
                try:
                    rank, ok, val = out.get(timeout=max(
                        1.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                (results if ok else errors)[rank] = val
                if time.monotonic() > deadline:
                    break
        finally:
            for p in procs:
                p.join(timeout=30)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        lost = any("address already in use" in e.lower()
                   for e in errors.values())
        if not lost:
            break
    check(not errors, f"34: {backend} ranks failed: " + "\n".join(
        f"rank {r}: {e}" for r, e in sorted(errors.items()))[-4000:])
    check(len(results) == nranks, f"34: {len(results)} of {nranks} "
          f"{backend} ranks answered within {timeout} s")
    check(all(p.exitcode == 0 for p in procs), "34: rank exit codes "
          f"{[p.exitcode for p in procs]}")
    return [results[r] for r in range(nranks)]


def distribution_phases(tt, dev, kernels, lp_n=1000, dense_iters=1000,
                        f32_iters=400, ell_n=65_536, ell_iters=500,
                        n34c=100, lanes34c=64, iters34c=8000,
                        fleet=(8, 64, 192), admm_rounds=4, coll_reps=200,
                        timeout=600):
    """Phase 34: the distribution layer, one process per rank. 34a the
    n = 1000 LP row-sharded on a 1-rank NCCL world (gloo off the card) and
    on a 2-rank gloo world whose ranks share the card; 34b the from-tiles
    blocked-ELL LP, 34c 29b's batch64 and 34d 33's ADMM fleet on the
    2-rank world; 34e the ranks joined through ``multihost.init``. Every
    result is held against the unsharded solve in this process. The
    kernels are built (phase 1) before the ranks start and load them from
    ``build/``. Returns the ranks' kernel launches (dual_matvec's)."""
    t34 = time.perf_counter()
    on_card = dev.type == "cuda"
    cfg = dict(lp_n=lp_n, dense_iters=dense_iters, f32_iters=f32_iters,
               ell_n=ell_n, ell_iters=ell_iters, n34c=n34c,
               lanes34c=lanes34c, iters34c=iters34c, fleet=fleet,
               admm_rounds=admm_rounds, coll_reps=coll_reps)
    counts = {k: 0 for k in kernels}
    # the unsharded references, in this process, before any rank starts
    ref_dense = _dense_runs(tt, dev, cfg, lambda p, q: p.solve_jit(q))
    c, op, b, lay = dist_data(tt, dev, cfg, "ell")
    ref_ell, wall_ell = _timed(dev, lambda: tt.solve_jit(
        c, op, b, lay, tt.SolverParam(max_iter=ell_iters, **P34B)))
    m_ell, n_ell = op.shape
    del op
    c, a, b, lay = dist_data(tt, dev, cfg, "batch")
    p34c = tt.SolverParam(max_iter=iters34c, **P34C)
    tt.solve_batch(c, a, b, lay, tt.SolverParam(max_iter=40, **P34C))
    ref_batch, wall_batch = _timed(dev, lambda: tt.solve_batch(
        c, a, b, lay, p34c))
    # each rank's lanes alone, unsharded: a lockstep lane's rounding on
    # the card depends on the batch's size (the reductions' and bmm's
    # launch shapes), so a rank's 32 lanes are held bitwise to these and
    # within the lane bound to the 64-lane batch
    halves = [slice(0, lanes34c // 2), slice(lanes34c // 2, lanes34c)]
    ref_halves = [tt.solve_batch(c[h], a[h], b[h], lay, p34c)
                  for h in halves]
    c, a, b, lay = dist_data(tt, dev, cfg, "admm")
    ref_admm = tt.consensus_admm(c, a, b, lay, max_outer=admm_rounds,
                                 tol=0.0, param=tt.SolverParam(**P34D))
    del c, a, b

    worlds = {"1 rank " + ("NCCL" if on_card else "gloo"): run_ranks(
        1, "nccl" if on_card else "gloo", dev.type, cfg, ["dense"],
        timeout),
        "2 ranks gloo": run_ranks(2, "gloo", dev.type, cfg,
                                  ["dense", "ell", "batch", "admm"],
                                  timeout)}

    # ---- 34a: dense row sharding against the unsharded solve
    st64, it64, x64, _, _ = ref_dense["float64"]
    _, it32, _, wall32, _ = ref_dense["float32"]
    bound = 1e-9 * max(1.0, float(np.abs(x64).max()))
    line = []
    for world, recs in worlds.items():
        for r, rec in enumerate(recs):
            d = rec["dense"]
            st, it, x, _, launches = d["runs"]["float64"]
            err = float(np.abs(x - x64).max())
            check(st == st64 and it == it64 and err <= bound,
                  f"34a {world} rank {r}: status {st}, {it} iterations, "
                  f"|x - x_unsharded| {err:.3e} against status {st64}, "
                  f"{it64} iterations, bound {bound:.3e}")
            check(not on_card or launches >= 2 * it,
                  f"34a {world} rank {r}: {launches} dual_matvec launches "
                  f"for {it} iterations")
            check(d["one"] == ({("gather", 4 * lp_n): 1, ("sum", lp_n): 1},
                               1 if on_card else 0),
                  f"34a {world} rank {r}: one dual_matvec made {d['one']}")
            counts["dual_matvec"] += launches + d["runs"]["float32"][4] \
                + d["one"][1]
            _, it_s, _, wall_s, _ = d["runs"]["float32"]
            line.append(
                f"{world} rank {r} ({d['rows']} rows): f64 {it} "
                f"iterations, |x - x_unsharded|_inf {err:.2e} (bound "
                f"{bound:.1e}{', bitwise' if err == 0 else ''}), "
                f"{launches / it:.2f} dual_matvec launches/iteration; f32 "
                f"{1e6 * wall_s / it_s:.1f} us/iteration (unsharded "
                f"{1e6 * wall32 / it32:.1f}); {d['us_per_collective']:.1f} "
                f"us per collective (n-sum, back to back), 2 collectives "
                f"per dual_matvec; collectives in the f32 solve "
                f"{sum(d['counts']['torch.float32'].values())}")
    print(f"phase 34a dense row sharding, bench.make_lp({lp_n}) (A "
          f"{4 * lp_n}x{lp_n}), Halpern + Ruiz + normalize, f64 "
          f"{dense_iters} and f32 {f32_iters} iterations, against the "
          f"unsharded solve ({it64} iterations, status {st64}): "
          + "; ".join(line) + " (both ranks of the 2-rank world share one "
          "card: no speed-up is expected)", flush=True)

    # ---- 34b-34e on the 2-rank world
    recs = worlds["2 ranks gloo"]
    xe = ref_ell.x.double().cpu().numpy()
    bound_e = 1e-5 * max(1.0, float(np.abs(xe).max()))
    line = []
    for r, rec in enumerate(recs):
        e = rec["ell"]
        err = float(np.abs(e["x"].astype(np.float64) - xe).max())
        sizes = {k for k in e["counts"]}
        check(e["iters"] == ref_ell.iters and e["status"] == ref_ell.status
              and err <= bound_e,
              f"34b rank {r}: status {e['status']}, {e['iters']} iterations"
              f", |x - x_unsharded| {err:.3e} (bound {bound_e:.1e})")
        check(all(k == "gather" and s in (m_ell, n_ell) for k, s in sizes),
              f"34b rank {r}: collectives {e['counts']}")
        line.append(f"rank {r} tiles {e['tiles']}: {e['iters']} iterations"
                    f" in {e['wall']:.2f} s, |x - x_unsharded|_inf "
                    f"{err:.2e}{' (bitwise)' if err == 0 else ''}, "
                    f"collectives {e['counts']}")
    print(f"phase 34b blocked-ELL sharding, the from-tiles LP n={ell_n} "
          f"(A {m_ell}x{n_ell} f32 as one BlockedEllOp), pdhg "
          f"{ell_iters} iterations, 2 gloo ranks on one card, against the "
          f"unsharded solve ({ref_ell.iters} iterations, {wall_ell:.2f} s):"
          f" " + "; ".join(line) + " (only (m,) and (n,) gathers: no tile "
          "moves)", flush=True)

    line = []
    half = lanes34c // 2
    for r, rec in enumerate(recs):
        bt = rec["batch"]
        mine = halves[r]
        alone = ref_halves[r]
        check(np.array_equal(bt["x"][mine], alone.x.cpu().numpy())
              and np.array_equal(bt["status"][mine],
                                 alone.status.cpu().numpy())
              and np.array_equal(bt["iters"][mine],
                                 alone.iters.cpu().numpy()),
              f"34c rank {r}: its lanes differ from the unsharded batch of "
              "the same lanes")
        x64 = ref_batch.x[mine].cpu().numpy()
        err = float(np.abs(bt["x"][mine] - x64).max())
        lane_bound = 1e-3 * (1.0 + float(np.abs(x64).max()))
        check(np.array_equal(bt["status"], ref_batch.status.cpu().numpy())
              and np.array_equal(bt["iters"], ref_batch.iters.cpu().numpy())
              and err <= lane_bound,
              f"34c rank {r}: statuses, iterations or x (err {err:.3e}, "
              f"bound {lane_bound:.1e}) differ from the {lanes34c}-lane "
              "batch")
        n34, m34 = ref_batch.x.shape[1], ref_batch.y.shape[1]
        check(bt["counts"] == {("gather", lanes34c * (n34 + m34 + 5)): 1,
                               ("gather", 2 * lanes34c): 1},
              f"34c rank {r}: collectives {bt['counts']}")
        rate = half * iters34c / bt["wall"]
        line.append(f"rank {r}: lanes {mine.start}-{mine.stop - 1} bitwise "
                    f"the unsharded batch of those lanes, |x - x_{lanes34c}"
                    f"|_inf {err:.2e} (lane bound {lane_bound:.1e}), "
                    f"{bt['wall']:.3f} s, {rate:.0f} lane-iterations/s")
    print(f"phase 34c batch sharding, 29b's {lanes34c} n={n34c} LPs, "
          f"{iters34c} iterations at eps_acc 1e-9, batch mesh of 2 gloo "
          f"ranks: the same statuses and iterations as the unsharded batch "
          f"({wall_batch:.3f} s, {lanes34c * iters34c / wall_batch:.0f} "
          f"lane-iterations/s; its halves alone differ from it by "
          + ", ".join(f"{float((h.x - ref_batch.x[s]).abs().max()):.2e}"
                      for h, s in zip(ref_halves, halves))
          + "); " + "; ".join(line) + "; collectives: only "
          "the two gathers of the results (none inside the loop)",
          flush=True)

    zr = np.asarray(ref_admm.z)
    errs = [float(np.abs(rec["admm"]["z"] - zr).max()) for rec in recs]
    check(max(errs) <= 1e-6 and all(rec["admm"]["rounds"] == admm_rounds
                                    for rec in recs),
          f"34d: |z - z_unsharded| {errs}")
    print(f"phase 34d consensus ADMM, 33's fleet {fleet} in f64, "
          f"{admm_rounds} rounds on a batch mesh of 2 gloo ranks: |z - "
          f"z_unsharded|_inf " + ", ".join(f"{e:.2e}" for e in errs)
          + f"; {recs[0]['admm']['wall']:.2f} s; collectives "
          f"{recs[0]['admm']['counts']}", flush=True)

    for world, rs in worlds.items():
        for r, rec in enumerate(rs):
            check(rec["multihost"] == (len(rs) > 1),
                  f"34e {world} rank {r}: is_multihost() "
                  f"{rec['multihost']}")
    print("phase 34e multihost.init (tcp://127.0.0.1) on every rank: "
          + "; ".join(f"{world}: backend {rs[0]['backend']}, is_multihost "
                      f"{[rec['multihost'] for rec in rs]}"
                      for world, rs in worlds.items())
          + f"; phase 34 took {time.perf_counter() - t34:.1f} s",
          flush=True)
    return counts


def native_phase(tt, dev, kernels):
    """Phase 35: the native C++ engine on the card's host. Kernel B's f64
    output (its plain version off the card) on phase 2b's exp and pow
    blocks against the engine's bisection: every block within 1e-9 of the
    block's norm, except blocks where kernel B's plain version departs
    from it too (the root finder both share), which must be the same
    blocks; the golden LP on ``solve_native`` in 160 iterations."""
    from totsu_tpu_torch import native
    cp = kernels["cone_proj"]
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    exp_np = cone_blocks("exp", 2000, rng)
    pow_np = np.concatenate([cone_blocks("pow", 500, rng, al)
                             for al in (0.1, 0.3, 0.5, 0.9)])
    alphas = (0.1, 0.3, 0.5, 0.9)
    f64 = torch.float64
    line = []
    for kind, blk in (("exp", exp_np), ("pow", pow_np)):
        xb = torch.tensor(blk, dtype=f64, device=dev)
        al = (torch.tensor(np.repeat(alphas, 500), dtype=f64, device=dev)
              if kind == "pow" else 0.0)
        kern = (cp.cone_proj_cuda if dev.type == "cuda"
                else cp.cone_proj_plain)(xb, kind, al, False)
        plain = cp.cone_proj_plain(xb, kind, al, False)
        t1 = time.perf_counter()
        nat = (native.proj_exp_native(blk) if kind == "exp"
               else np.concatenate([native.proj_pow_native(
                   blk[i * 500:(i + 1) * 500], a)
                   for i, a in enumerate(alphas)]))
        nat_ms = 1e3 * (time.perf_counter() - t1)
        nrm = np.maximum(np.linalg.norm(blk, axis=1), 1e-300)
        err_k = np.abs(kern.cpu().numpy() - nat).max(1) / nrm
        err_p = np.abs(plain.cpu().numpy() - nat).max(1) / nrm
        off_k = set(np.nonzero(err_k > 1e-9)[0].tolist())
        off_p = set(np.nonzero(err_p > 1e-9)[0].tolist())
        check(off_k == off_p, f"35 {kind}: blocks past 1e-9 of the native "
              f"projection: kernel B {sorted(off_k)[:20]}, its plain "
              f"version {sorted(off_p)[:20]}")
        kept = err_k[[i for i in range(len(blk)) if i not in off_k]]
        line.append(f"{kind}: max error / block norm {kept.max():.2e} "
                    f"(plain {err_p.max():.2e}), blocks where both depart "
                    f"(the shared root finder's stall) {len(off_k)}, native "
                    f"{nat_ms:.1f} ms for {len(blk)} blocks")
    golden = np.array([1.9999994251590176, 2.0000004472430635])
    x, _, status, iters = native.solve_native(
        [-1.0, 0.0], [[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]],
        [6.0, 6.0, 1.0], tt.ConeLayout([tt.rpos(3)]),
        tt.SolverParam(max_iter=100_000))
    check(iters == 160 and status == tt.SolverStatus.CONVERGED
          and np.abs(x - golden).max() <= 1e-9,
          f"35: the golden LP on solve_native: {status}, {iters} "
          f"iterations, x = {x.tolist()}")
    print(f"phase 35 native engine (g++ -O3 -march=native, built/loaded in "
          f"{build_s:.2f} s): kernel B f64 on phase 2b's 2000 exp and 2000 "
          f"pow blocks against proj_exp_native / proj_pow_native: "
          + "; ".join(line) + f"; golden LP on solve_native: {iters} "
          f"iterations, max |x - golden| {np.abs(x - golden).max():.1e}",
          flush=True)


# ---- phase 38: batches of structured operators (BatchedOp) on both
# engines


def highs_box(n, seed):
    """HiGHS's objective of ``make_banded_box_lp(n, seed=seed)`` in f64
    (sparse, interior point), its status and seconds (phase 38a's
    reference, run in a child process beside the card's work)."""
    from scipy import sparse
    from scipy.optimize import linprog
    c, a, b = make_banded_box_lp(n, seed=seed)
    t0 = time.perf_counter()
    hi = linprog(c.astype(np.float64),
                 A_ub=sparse.csr_matrix(a.astype(np.float64)),
                 b_ub=b.astype(np.float64), bounds=(None, None),
                 method="highs-ipm")
    return {"status": hi.status, "fun": hi.fun,
            "seconds": time.perf_counter() - t0}


def start_highs_box(n, seeds):
    """One child process per seed running :func:`highs_box`, on the CPU
    only; returns a function that waits for them and returns their
    results in the seeds' order. The children are stopped on any exit."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--highs-box",
         json.dumps([n, s])], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for s in seeds]
    for p in procs:
        atexit.register(stop, p)

    def results():
        out = []
        for p in procs:
            text, err = p.communicate(timeout=600)
            check(p.returncode == 0, f"HiGHS child failed: {err}")
            out.append(json.loads(text.strip().splitlines()[-1]))
        return out

    return results


def stencil_csr(w, n):
    """The stencil CustomOp's matrix (``make_stencil_op``: s = w0 x +
    w1 roll(x, 1) + w2 roll(x, -1), then the box rows x and -x) as a
    scipy CSR matrix, (3n, n)."""
    from scipy import sparse
    i = np.arange(n)
    s = sparse.csr_matrix(
        (np.concatenate([np.full(n, w[0]), np.full(n, w[1]),
                         np.full(n, w[2])]),
         (np.concatenate([i, i, i]),
          np.concatenate([i, (i - 1) % n, (i + 1) % n]))), shape=(n, n))
    eye = sparse.identity(n, format="csr", dtype=np.float64)
    return sparse.vstack([s, eye, -eye]).tocsr()


def structured_batch_phases(tt, dev, kernels, n38=4096, lanes38=4, k38=48,
                            lanes38c=8, iters38b=2000, prof38=200,
                            iters38d=200, n38e=256):
    """Phase 38: lockstep batches of structured operators (``BatchedOp``)
    on the card, each path driven once through ``solve_batch`` or the
    batch-leading differentiable solver, the launch counts set to 0 just
    before it (the sizes are arguments only so that the flow can be
    rehearsed small):

    * 38a: ``lanes38`` lanes of phase 21's banded box LP (n = ``n38``, the
      seeds 0, 1, ...) as ``BatchedOp.stack`` of BlockedEllOps (128 x 128
      tiles, one structure) on the indirect engine with Halpern to eps_acc
      1e-3: every lane CONVERGED with its objective within 5e-3 of HiGHS
      (children beside the card), each lane against its own solve_jit
      (status, iterations within a check period, x within 1e-3 (1 +
      |x|inf)), chunks of 100 bitwise the whole batch;
    * 38b: the same batch on pdhg for ``iters38b`` iterations, its check
      period a CUDA graph against eager: bitwise; the lane-iterations per
      second of each and ``prof38`` iterations under the profiler;
    * 38c: ``lanes38c`` structured partitioning SDPs at k = ``k38`` (the
      lanes differ in c) on psd 'jacobi' to eps_acc 1e-3: every lane
      CONVERGED with diag(X) = 1 within eps_acc (1 + ||b||), lanes 0 and
      the last against their single solves, kernel J taking every lane's
      block in each launch; its events time at (k38, lanes38c);
    * 38d: the other forms at 38a's size for ``iters38d`` pdhg
      iterations, each lane against 38a's BlockedEllOp batch (a VStackOp,
      a ScaledOp by powers of two: bitwise; a SparseOp; the stencil
      CustomOp with lane-leading weights, hand and autograd adjoints,
      against its BlockedEllOp twin), then 2 lanes of the batch-leading
      differentiable solver at n = ``n38e`` in f64: each lane's tile
      cotangent against the dense closed form at the same solution.

    Returns the kernels' launch counts over these paths."""
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj
    from totsu_tpu_torch.solver import batched
    f32, f64 = torch.float32, torch.float64
    rep = dataclasses.replace
    counts = {k: 0 for k in kernels}
    t38 = time.perf_counter()
    seeds = list(range(lanes38))
    highs = start_highs_box(n38, seeds)

    def count(runs):
        for r in runs.values():
            for k in kernels:
                counts[k] += r[2][k]
        return {k: sum(r[2][k] for r in runs.values()) for k in kernels}

    def rel(got, want):
        return abs(got - want) / max(1.0, abs(want))

    def xerr(r1, r2):
        """max |x1 - x2| over max(1, |x2|inf), every lane."""
        d = (r1.x.double() - r2.x.double()).abs().max()
        return float(d) / max(1.0, float(r2.x.double().abs().max()))

    # ---- 38a: the indirect engine
    lps = [make_banded_box_lp(n38, seed=s) for s in seeds]
    cb = torch.from_numpy(np.stack([lp[0] for lp in lps])).to(dev)
    bb = torch.from_numpy(np.stack([lp[2] for lp in lps])).to(dev)
    ells = [tt.BlockedEllOp.from_dense(lp[1], block=(128, 128), device=dev)
            for lp in lps]
    ellb = tt.BatchedOp.stack(ells)
    cone = tt.ConeLayout([tt.rpos(3 * n38)])
    p38a = tt.SolverParam(max_iter=400_000, eps_acc=1e-3, method="direct",
                          accel="halpern", check_period=20)
    runs38a = drive({
        "38a ELL batch, indirect engine": lambda: BatchRun(
            tt.solve_batch(cb, ellb, bb, cone, p38a)),
        "38a ELL batch, indirect engine, chunks of 100": lambda: BatchRun(
            tt.solve_batch(cb, ellb, bb, cone, p38a, chunk_iters=100)),
    }, kernels)
    cnt38a = count(runs38a)
    run_a, wall_a, _, _ = runs38a["38a ELL batch, indirect engine"]
    res_a = run_a.res
    res_ac = runs38a["38a ELL batch, indirect engine, chunks of 100"][0].res
    check(bool((res_a.status == tt.SolverStatus.CONVERGED).all()),
          f"38a: statuses {res_a.status.tolist()}")
    check(same_batch(res_ac, res_a), "38a: chunks of 100 differ from the "
          "whole batch")
    singles = []
    for i in seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = tt.solve_jit(cb[i], ells[i], bb[i], cone, p38a)
        torch.cuda.synchronize()
        singles.append((one, time.perf_counter() - t0))
    rows_a = []
    for i, (one, wall1) in enumerate(singles):
        x1 = one.x.double().cpu().numpy()
        err = float(np.abs(res_a.x[i].double().cpu().numpy() - x1).max())
        bound = 1e-3 * (1.0 + float(np.abs(x1).max()))
        check(one.status == int(res_a.status[i])
              and abs(one.iters - int(res_a.iters[i])) <= 20
              and err <= bound,
              f"38a lane {i}: status {int(res_a.status[i])}/{one.status}, "
              f"iterations {int(res_a.iters[i])}/{one.iters}, x error "
              f"{err:.3e} (limit {bound:.3e})")
        rows_a.append((i, int(res_a.iters[i]), one.iters, err, bound))
    objs = [float(np.dot(lp[0].astype(np.float64),
                         res_a.x[i].double().cpu().numpy()))
            for i, lp in enumerate(lps)]
    cg = res_a.diag["cg_steps"] / int(res_a.iters.max())
    t38b = time.perf_counter()

    # ---- 38b: pdhg, the check period a CUDA graph against eager
    p38b = tt.SolverParam(max_iter=iters38b, eps_acc=1e-12,
                          check_period=100)
    graphed = batched._graphable(cone, dev, ellb)
    try:
        runs38b = drive({
            "38b ELL batch, pdhg graphed": lambda: BatchRun(
                tt.solve_batch(cb, ellb, bb, cone, p38b)),
        }, kernels)
        batched.CUDA_GRAPHS = False
        runs38b.update(drive({
            "38b ELL batch, pdhg eager": lambda: BatchRun(
                tt.solve_batch(cb, ellb, bb, cone, p38b)),
        }, kernels))
    finally:
        batched.CUDA_GRAPHS = True
    cnt38b = count(runs38b)
    run_g, wall_g, _, _ = runs38b["38b ELL batch, pdhg graphed"]
    run_e, wall_e, _, _ = runs38b["38b ELL batch, pdhg eager"]
    check(same_batch(run_g.res, run_e.res)
          and bool((run_g.res.iters == iters38b).all()),
          f"38b: graphed {run_g.res.iters.tolist()} and eager "
          f"{run_e.res.iters.tolist()} iterations, bitwise "
          f"{same_batch(run_g.res, run_e.res)}")
    wall_p, busy_p, nl_p, _ = profile_loop(
        lambda: tt.solve_batch(cb, ellb, bb, cone,
                               rep(p38b, max_iter=prof38)), prof38)
    res_b = run_g.res
    t38c = time.perf_counter()

    # ---- 38c: kernel J on a structured batch
    parts = [make_partitioning_structured(k38, seed=10_000 + i)
             for i in range(lanes38c)]
    _, _, neg_d, sel, b_sdp = parts[0]
    sdp_op = tt.BatchedOp.stack([
        tt.VStackOp((tt.DiagOp(torch.tensor(p[2], device=dev)),
                     tt.DenseOp(torch.tensor(p[3], device=dev))))
        for p in parts])
    c_sdp = torch.tensor(np.stack([p[1] for p in parts]), device=dev)
    b_sdpt = torch.tensor(np.stack([p[4] for p in parts]), device=dev)
    cone_c = tt.ConeLayout([tt.psd(k38, method="jacobi"), tt.zero(k38)])
    p38c = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, profile="fast")
    shapes_j = []
    real_j = pj.proj_psd_jacobi

    def recorded(v, *args, **kw):
        shapes_j.append(tuple(v.reshape(-1, v.shape[-1]).shape))
        return real_j(v, *args, **kw)

    pj.proj_psd_jacobi = recorded
    try:
        runs38c = drive({"38c partitioning SDP batch, jacobi": lambda:
                         BatchRun(tt.solve_batch(c_sdp, sdp_op, b_sdpt,
                                                 cone_c, p38c))}, kernels)
    finally:
        pj.proj_psd_jacobi = real_j
    cnt38c = count(runs38c)
    run_c, wall_c, _, _ = runs38c["38c partitioning SDP batch, jacobi"]
    res_c = run_c.res
    check(bool((res_c.status == tt.SolverStatus.CONVERGED).all()),
          f"38c: statuses {res_c.status.tolist()}")
    sn = k38 * (k38 + 1) // 2
    diag_slots = np.nonzero(pack_index(k38)[0] == pack_index(k38)[1])[0]
    diag_err = float((res_c.x[:, diag_slots].double() - 1.0).abs().max())
    diag_lim = 1e-3 * (1.0 + float(np.linalg.norm(b_sdp)))
    check(diag_err <= diag_lim, f"38c: |diag(X) - 1| {diag_err:.2e} > "
          f"{diag_lim:.2e}")
    rows_c = []
    for i in (0, lanes38c - 1):
        one = tt.solve_jit(c_sdp[i], sdp_op.lane(i), b_sdpt[i], cone_c, p38c)
        check(one.status == int(res_c.status[i])
              and abs(one.iters - int(res_c.iters[i])) <= 20,
              f"38c lane {i}: status {int(res_c.status[i])}/{one.status}, "
              f"iterations {int(res_c.iters[i])}/{one.iters}")
        rows_c.append((i, int(res_c.iters[i]), one.iters))
    on_card = dev.type == "cuda"
    check(cnt38c["psd_jacobi"] > 0 and all(s == (lanes38c, sn)
                                           for s in shapes_j),
          f"38c: kernel J launches {cnt38c['psd_jacobi']}, shapes "
          f"{sorted(set(shapes_j))} (each should be ({lanes38c}, {sn}))")
    v_j = torch.tensor(np.random.default_rng(38).normal(
        size=(lanes38c, sn)), dtype=f32, device=dev)
    j_ms = stream_ms(lambda: pj.proj_psd_jacobi(v_j), 20)
    j_bound = psd_jacobi_bound(pj, k38, lanes38c, f32)
    t38d = time.perf_counter()

    # ---- 38d: the other forms against 38a's BlockedEllOp batch, then the
    # batch-leading differentiable solver
    p38d = tt.SolverParam(max_iter=iters38d, eps_acc=1e-12,
                          check_period=100)
    ones = torch.ones(lanes38, n38, dtype=f32, device=dev)
    bands = [tt.BlockedEllOp.from_dense(np.ascontiguousarray(lp[1][:n38]),
                                        block=(128, 128), device=dev)
             for lp in lps]
    alphas = [2.0 ** (i - 1) for i in seeds]
    forms = {
        "VStackOp": tt.BatchedOp.stack([
            tt.VStackOp((bands[i], tt.DiagOp(ones[i]), tt.DiagOp(-ones[i])))
            for i in seeds]),
        "ScaledOp": tt.BatchedOp.stack([
            tt.ScaledOp(alphas[i], rep(ells[i], blocks=ells[i].blocks
                                       / alphas[i], blocks_t=ells[i].blocks_t
                                       / alphas[i])) for i in seeds]),
        "SparseOp": tt.BatchedOp.stack([
            tt.SparseOp.from_dense(torch.from_numpy(lp[1]).to(dev))
            for lp in lps]),
    }
    paths = {"38d ELL batch": lambda: BatchRun(
        tt.solve_batch(cb, ellb, bb, cone, p38d))}
    for name, op in forms.items():
        paths[f"38d {name} batch"] = lambda op=op: BatchRun(
            tt.solve_batch(cb, op, bb, cone, p38d))
    # the stencil LP's operator with each lane's own weights (an order of
    # make_stencil_op's three, whose hand absolute sums hold for every
    # order), as a CustomOp (hand and autograd adjoints) and as its
    # BlockedEllOp twin
    orders = list(itertools.permutations([1.0, -0.45, -0.55]))
    weights = [np.array(orders[i % len(orders)], np.float32) for i in seeds]
    stencil_ops = {}
    for adj in (True, False):
        op0 = make_stencil_op(tt, n38, dev, adjoint=adj)
        stencil_ops[adj] = tt.BatchedOp.stack([
            rep(op0, params=torch.from_numpy(w).to(dev)) for w in weights])
    stencil_ell = tt.BatchedOp.stack([
        tt.BlockedEllOp.from_bsr(stencil_csr(w, n38).astype(np.float32),
                                 block=(128, 128), device=dev)
        for w in weights])
    paths["38d stencil ELL twin batch"] = lambda: BatchRun(
        tt.solve_batch(cb, stencil_ell, bb, cone, p38d))
    for adj in (True, False):
        paths[f"38d stencil CustomOp batch, "
              f"{'hand' if adj else 'autograd'} adjoint"] = \
            lambda adj=adj: BatchRun(tt.solve_batch(
                cb, stencil_ops[adj], bb, cone, p38d))
    runs38d = drive(paths, kernels)
    cnt38d = count(runs38d)
    ref_d = runs38d["38d ELL batch"][0].res
    ref_s = runs38d["38d stencil ELL twin batch"][0].res
    errs_d = {}
    for name, (run, wall, _, _) in runs38d.items():
        if name in ("38d ELL batch", "38d stencil ELL twin batch"):
            continue
        ref = ref_s if "stencil" in name else ref_d
        err = xerr(run.res, ref)
        limit = 0.0 if "ScaledOp" in name else 1e-5
        check(torch.equal(run.res.status, ref.status)
              and torch.equal(run.res.iters, ref.iters) and err <= limit,
              f"{name}: statuses {run.res.status.tolist()}, iterations "
              f"{run.res.iters.tolist()}, x {err:.2e} from the ELL batch "
              f"(limit {limit:.0e})")
        errs_d[name[4:-6] if name.endswith(" batch") else name[4:]] = (
            err, wall)
    # 2 lanes of the batch-leading differentiable solver in f64
    lps_e = [make_banded_box_lp(n38e, seed=s) for s in (1, 4)]
    batch_e = tt.BatchedOp.stack([
        tt.BlockedEllOp.from_dense(lp[1].astype(np.float64),
                                   block=(128, 128), device=dev)
        for lp in lps_e])
    blk, cols, blk_t, cols_t = batch_e.leaves
    blk = blk.clone().requires_grad_(True)
    blk_t = blk_t.clone().requires_grad_(True)
    op_e = batch_e.with_leaves([blk, cols, blk_t, cols_t])
    c_e, b_e = (torch.from_numpy(np.stack([lp[j] for lp in lps_e]).astype(
        np.float64)).to(dev).requires_grad_(True) for j in (0, 2))
    # as 28d's, the forward stops at eps_acc 1e-6
    solver_e = tt.make_differentiable_solver(
        tt.ConeLayout([tt.rpos(3 * n38e)]),
        tt.SolverParam(method="direct", accel="halpern", check_period=20,
                       eps_acc=1e-6, max_iter=400_000),
        lsqr_iters=LSQR_ITERS28)
    for mod in kernels.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_e, y_e = solver_e(c_e, op_e, b_e)
    gc_e, gb_e, g_blk, g_blk_t = torch.autograd.grad(
        (x_e * x_e).sum(), (c_e, b_e, blk, blk_t))
    torch.cuda.synchronize()
    wall_e38 = time.perf_counter() - t0
    for k in kernels:
        counts[k] += kernels[k].launches
    errs_e = []
    for i in range(2):
        tiles_g, tiles = ell_tile_cotangent(
            tt, batch_e.lane(i), g_blk[i], g_blk_t[i], 3 * n38e, n38e, 128)
        dense_g = (torch.outer(y_e[i].detach(), gc_e[i])
                   - torch.outer(gb_e[i], x_e[i].detach()))
        scale = float(dense_g.abs().max())
        err = float((tiles_g - torch.where(tiles, dense_g, 0.0)).abs().max())
        check(err <= 1e-8 * scale, f"38d lane {i}: tile cotangent "
              f"{err:.3e} from the dense closed form (limit 1e-8 of "
              f"{scale:.3e})")
        errs_e.append(err / scale)
    t38e = time.perf_counter()

    # the lanes' HiGHS objectives, computed beside the card's work
    his = highs()
    wait = time.perf_counter() - t38e
    for i, hi in enumerate(his):
        check(hi["status"] == 0 and rel(objs[i], hi["fun"]) <= 5e-3,
              f"38a lane {i}: objective {objs[i]} vs HiGHS {hi}")
    print(f"phase 38a {lanes38} lanes of the banded box LP n={n38} (A "
          f"{3 * n38}x{n38} f32 as BatchedOp.stack of BlockedEllOps, K="
          f"{ells[0].cols.shape[1]}) on the indirect engine (Halpern, "
          f"eps_acc 1e-3): CONVERGED at {res_a.iters.tolist()} "
          f"iterations, {1e3 * wall_a:.1f} ms ({res_a.diag['cg_steps']} "
          f"lockstep CG steps, {cg:.2f} per DR iteration of the worst "
          f"lane); objectives vs HiGHS: "
          + ", ".join(f"{o:.4f}/{hi['fun']:.4f} (rel "
                      f"{rel(o, hi['fun']):.1e})" for o, hi in zip(objs, his))
          + f" (HiGHS {max(h['seconds'] for h in his):.1f} s a lane, in "
          f"children); against their single solves: {fmt_lanes(rows_a)} "
          f"(singles {', '.join(f'{1e3 * w:.1f}' for _, w in singles)} "
          f"ms); chunks of 100 bitwise the whole; launches {cnt38a}; 38a "
          f"took {t38b - t38:.1f} s, set-up included", flush=True)
    print(f"phase 38b the same batch on pdhg, {iters38b} iterations "
          f"(check_period 100): the check period "
          + ("a CUDA graph" if graphed else "eager (not on a card)")
          + f" {lanes38 * iters38b / wall_g:.1f} lane-iterations/s, eager "
          f"{lanes38 * iters38b / wall_e:.1f}, bitwise; {prof38} lockstep "
          f"iterations under the profiler: {nl_p:.1f} launches, "
          f"{wall_p:.1f} us wall and {100 * busy_p / wall_p:.1f}% busy per "
          f"iteration; statuses {lanes_summary(res_b)[0]}; launches "
          f"{cnt38b}; 38b took {t38c - t38b:.1f} s", flush=True)
    print(f"phase 38c {lanes38c} structured partitioning SDPs k={k38} "
          f"(VStackOp(DiagOp, DenseOp), the lanes' c from seeds 10000-"
          f"{10_000 + lanes38c - 1}) on psd 'jacobi', profile='fast' "
          f"(eps_acc 1e-3): CONVERGED at {res_c.iters.tolist()} "
          f"iterations, {wall_c:.3f} s; |diag(X) - 1| {diag_err:.1e} (limit "
          f"{diag_lim:.1e}); lanes "
          + ", ".join(f"{i}: {bi}/{si}" for i, bi, si in rows_c)
          + f" iterations batch/single; kernel J {cnt38c['psd_jacobi']} "
          f"launches, each at (k, count) = ({k38}, {lanes38c}) "
          f"({cnt38c['psd_jacobi'] / int(res_c.iters.max()):.2f} per "
          f"lockstep iteration; PR 13's batch at (8, 512): 2 per update); "
          f"kernel J at ({k38}, {lanes38c}) f32 "
          + (f"{1e3 * j_ms:.2f} us (events)" if j_ms is not None
             else "not timed")
          + f" beside PERF.md's (48, 1) 310.59 us, bound "
          f"{1e3 * j_bound[0]:.2f} us ({j_bound[1]}); launches {cnt38c}; "
          f"38c took {t38d - t38c:.1f} s", flush=True)
    print(f"phase 38d {iters38d} pdhg iterations of {lanes38} lanes at "
          f"n={n38}, each form against the same lanes' BlockedEllOp batch "
          f"(x error over max(1, |x|inf)): "
          + ", ".join(f"{k} {e:.1e} ({1e3 * w:.0f} ms)"
                      for k, (e, w) in errs_d.items())
          + f"; batch-leading differentiable solver, 2 lanes n={n38e} "
          f"f64 BlockedEllOp: tile cotangents "
          + ", ".join(f"{e:.1e}" for e in errs_e)
          + f" of max |cotangent| from the dense closed form (limit 1e-8), "
          f"forward and backward {wall_e38:.2f} s ("
          f"{solver_e.stats['lsqr_steps']} LSQR steps); launches {cnt38d}; "
          f"38d took {t38e - t38d:.1f} s, the wait for HiGHS {wait:.1f} s; "
          f"phase 38 took {time.perf_counter() - t38:.1f} s"
          + ("" if on_card else " (on the CPU)"), flush=True)
    return counts


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
    kernels["megakernel_batch"] = BatchLaunches(mk)

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

    # ---- phases 27-28: polish and differentiation through solves
    t27 = time.perf_counter()
    for k, v in polish_diff_phases(tt, dev, kernels, refs,
                                   grid27=REF_KW["grid27"],
                                   ell_n=ELL_N28D).items():
        main_counts[k] += v

    # ---- phases 29-33: lockstep batches, BatchRunner and consensus ADMM
    t29 = time.perf_counter()
    kept29 = {}
    for k, v in batch_phases(tt, dev, kernels, kept=kept29).items():
        main_counts[k] += v

    # ---- phase 36: the batched megakernel on phase 29's batches and
    # past one resident wave; phase 37: the examples on the card
    t36 = time.perf_counter()
    counts36, mega_batch_record = batch_mega_phases(tt, dev, kernels, kept29)
    del kept29
    for counts in (counts36, examples_phase(dev, kernels)):
        for k, v in counts.items():
            main_counts[k] += v

    # ---- phase 34: distribution over ranks (each its own process; the
    # ranks' dual_matvec launches count); phase 35: the native engine
    t34 = time.perf_counter()
    for k, v in distribution_phases(tt, dev, kernels).items():
        main_counts[k] += v
    native_phase(tt, dev, kernels)

    # ---- phase 38: batches of structured operators on both engines
    t38 = time.perf_counter()
    for k, v in structured_batch_phases(tt, dev, kernels).items():
        main_counts[k] += v
    # kernel J's launches over every path (phase 28a's DPi builds too), the
    # batched megakernel's over every path (phase 36's six and any other)
    jacobi_record["launches"] = main_counts["psd_jacobi"]
    mega_batch_record["launches"] = main_counts["megakernel_batch"]
    check(main_counts["megakernel_batch"] > 0,
          "the main path launched megakernel_batch no time")
    t_end = time.perf_counter()
    print(f"all phases passed in {t_end - t_start:.1f} s "
          f"(phases 23-26 from {t23 - t_start:.1f} s, phases 27-28 from "
          f"{t27 - t_start:.1f} s: {t29 - t27:.1f} s, phases 29-33 from "
          f"{t29 - t_start:.1f} s: {t36 - t29:.1f} s, phases 36-37 from "
          f"{t36 - t_start:.1f} s: {t34 - t36:.1f} s, phases 34-35 from "
          f"{t34 - t_start:.1f} s: {t38 - t34:.1f} s, phase 38 from "
          f"{t38 - t_start:.1f} s: {t_end - t38:.1f} s)", flush=True)

    primal = cp_main[False]
    record = {"kernels": [
        {"name": "dual_matvec", "route": "cuda",
         "source": "totsu_tpu_torch/csrc/dual_matvec.cu",
         "replaces": "totsu_tpu/ops/pallas/dual_matvec.py:55",
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
        mega_batch_record,
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-references"]:
        print(json.dumps(cpu_references(**json.loads(sys.argv[2]))))
    elif sys.argv[1:2] == ["--highs-box"]:
        print(json.dumps(highs_box(*json.loads(sys.argv[2]))))
    else:
        main()
