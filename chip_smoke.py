"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds both CUDA kernels of the dense pdhg path from
``totsu_tpu_torch/csrc`` (nvcc, sm_90a), holds each against its plain
PyTorch version on the card, drives the solver's main path at full width
(the n=1000 benchmark LP: A is 4000 x 1000 f32) and the megakernel path,
and checks the answers. Each phase prints one line of its own numbers;
any failed check raises, so the script exits non-zero and prints no final
line. It needs a CUDA device and the repository beside it; it imports
nothing of JAX.

The last two lines of standard output are the kernels' JSON record and
the JSON status line ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
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


def device_ms(fn, calls=50):
    """Device milliseconds per call of ``fn()``: the kernel time the
    profiler attributes to the calls (host time between kernels
    excluded); None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # kernel events only: an operator's own row repeats its kernels' time
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / calls if total_us > 0 else None


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


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    import totsu_tpu_torch as tt
    from totsu_tpu_torch import interop
    from totsu_tpu_torch.ops.kernels import _build
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    from totsu_tpu_torch.ops.kernels import megakernel as mk

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"setup: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}; card: {smi}", flush=True)

    # ---- phase 1: build both kernels from the sources in the checkout
    t0 = time.perf_counter()
    for name in ("dual_matvec", "megakernel"):
        _build.load(name)
    build_s = time.perf_counter() - t0
    print("phase 1 build: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in _build.build_seconds.items())
        + f"; total {build_s:.2f} s", flush=True)

    # ---- phase 2: dual_matvec against its plain version
    # error bound: max |kernel - plain| <= rtol * max |plain| (f32 sums run
    # in another order; bf16 storage is held against the f32 products of
    # the rounded matrix, which is what the plain version computes)
    rtols = {torch.float32: 2e-4, torch.bfloat16: 2e-4,
             torch.float64: 1e-12}
    dm_err = {}
    rng = np.random.default_rng(0)
    for (m, n) in [(4000, 1000), (400, 100), (173, 77), (8, 128)]:
        a64 = torch.from_numpy(rng.normal(size=(m, n))).to(dev)
        u64 = torch.from_numpy(rng.normal(size=n)).to(dev)
        v64 = torch.from_numpy(rng.normal(size=m)).to(dev)
        for dt, rtol in rtols.items():
            acc = dm.acc_dtype(dt)
            a = a64.to(dt).contiguous()
            u, v = u64.to(acc), v64.to(acc)
            p, q = dm.dual_matvec_cuda(a, u, v)
            pp, qp = dm.dual_matvec_plain(a, u, v)
            torch.cuda.synchronize()
            err = max(float((p - pp).abs().max()), float((q - qp).abs().max()))
            scale = max(float(pp.abs().max()), float(qp.abs().max()))
            check(err <= rtol * scale,
                  f"dual_matvec {dt} ({m}, {n}): max err {err:.3e} > "
                  f"{rtol:g} * {scale:.3e}")
            dm_err[(m, n, str(dt))] = err
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

    def fmt(x):
        return "n/a" if x is None else f"{x:.4f}"
    print("phase 2 dual_matvec vs plain: ok at (4000,1000) (400,100) "
          "(173,77) (8,128) x f32/bf16/f64; max err at (4000,1000) "
          + ", ".join(f"{k.split('.')[-1]} {dm_err[(4000, 1000, k)]:.3e}"
                      for k in times)
          + "; ms per call kernel/plain at (4000,1000) [device ms "
          "kernel/plain] "
          + ", ".join(f"{k.split('.')[-1]} {t[0]:.4f}/{t[1]:.4f} "
                      f"[{fmt(t[2])}/{fmt(t[3])}]"
                      for k, t in times.items()), flush=True)

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

    # ---- the main path: the full-width LP through solve(), then the
    # megakernel solves of the n=100 LP and the QP; launch counts are
    # set to 0 just before and read just after
    c1, a1, b1 = make_lp(1000)
    lp_cone = tt.ConeLayout([tt.rpos(a1.shape[0])])
    c1t, a1t, b1t = interop.problem_from_numpy(c1, a1, b1, device=dev,
                                               dtype=torch.float32)
    p_full = tt.SolverParam(accel="halpern", normalize=True, equil_iters=10,
                            check_period=20, eps_acc=1e-3, max_iter=200_000)
    c2, a2, b2 = make_lp(100)
    c2t, a2t, b2t = interop.problem_from_numpy(c2, a2, b2, device=dev,
                                               dtype=torch.float32)
    lp2_cone = tt.ConeLayout([tt.rpos(a2.shape[0])])
    qp_data = [torch.from_numpy(x).to(dev) for x in make_qp(50)]
    qprob = tt.problems.qp(*qp_data)
    # the megakernel solves use the full-width solve's settings
    p_mega = dataclasses.replace(p_full, kernel="mega")

    recorded = []  # the megakernel's inputs, to hold it against its plain
    real_solve_mega = mk.solve_mega

    def recording_solve_mega(*args, **kwargs):
        recorded.append((args, kwargs))
        return real_solve_mega(*args, **kwargs)

    mk.solve_mega = recording_solve_mega
    dm.launches = mk.launches = 0
    t0 = time.perf_counter()
    r_full = tt.solve(c1t, a1t, b1t, lp_cone, p_full)
    torch.cuda.synchronize()
    wall_full = time.perf_counter() - t0
    dm_full = dm.launches
    t0 = time.perf_counter()
    r_lp_m = tt.solve(c2t, a2t, b2t, lp2_cone, p_mega)
    torch.cuda.synchronize()
    wall_lp_m = time.perf_counter() - t0
    mk_lp = mk.launches
    t0 = time.perf_counter()
    r_qp_m = qprob.solve(p_mega)
    torch.cuda.synchronize()
    wall_qp_m = time.perf_counter() - t0
    main_counts = {"dual_matvec": dm.launches, "megakernel": mk.launches}
    mk.solve_mega = real_solve_mega
    for name, count in main_counts.items():
        check(count > 0, f"the main path launched {name} no time")

    # ---- phase 4: full-width solve checks
    from scipy.optimize import linprog
    check(r_full.converged, f"n=1000 LP status {r_full.status}")
    obj = float(np.dot(c1.astype(np.float64),
                       r_full.x.double().cpu().numpy()))
    t0 = time.perf_counter()
    hi = linprog(c1.astype(np.float64), A_ub=a1.astype(np.float64),
                 b_ub=b1.astype(np.float64), bounds=(None, None),
                 method="highs")
    highs_s = time.perf_counter() - t0
    check(hi.status == 0, f"HiGHS status {hi.status}: {hi.message}")
    rel = abs(obj - hi.fun) / max(1.0, abs(hi.fun))
    check(rel <= 5e-3, f"n=1000 objective {obj} vs HiGHS {hi.fun} "
          f"(rel {rel:.3e})")
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
          f"{hi.fun:.6f} (rel {rel:.2e}, HiGHS {highs_s:.2f} s); repeat "
          "solve: same iterations, bitwise-equal x", flush=True)

    # ---- phase 5: megakernel solves against the host loop
    p_loop = p_full
    t0 = time.perf_counter()
    r_lp_x = tt.solve(c2t, a2t, b2t, lp2_cone, p_loop)
    torch.cuda.synchronize()
    wall_lp_x = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_qp_x = qprob.solve(p_loop)
    torch.cuda.synchronize()
    wall_qp_x = time.perf_counter() - t0
    check(mk_lp == 1 and main_counts["megakernel"] == 2,
          f"megakernel launches per solve: {mk_lp}, "
          f"{main_counts['megakernel'] - mk_lp}")
    rels = []
    for what, rm, rx, k in (("LP n=100", r_lp_m, r_lp_x, 100),
                            ("QP n=50", r_qp_m, r_qp_x, 50)):
        check(rm.converged and rx.converged,
              f"{what}: status mega {rm.status}, loop {rx.status}")
        xm, xx = rm.x[:k].double().cpu(), rx.x[:k].double().cpu()
        rel_x = float((xm - xx).abs().max() / xx.abs().max().clamp(min=1.0))
        check(rel_x <= 1e-3, f"{what}: x differs by {rel_x:.3e} relative")
        rels.append(rel_x)
    print(f"phase 5 megakernel vs host loop: LP n=100 {r_lp_m.iters}/"
          f"{r_lp_x.iters} iterations, {wall_lp_m:.3f}/{wall_lp_x:.3f} s; "
          f"QP n=50 {r_qp_m.iters}/{r_qp_x.iters} iterations, "
          f"{wall_qp_m:.3f}/{wall_qp_x:.3f} s; x rel diff "
          f"{rels[0]:.2e}, {rels[1]:.2e}; 1 launch per mega solve",
          flush=True)

    # the megakernel against its plain version (the host loop) on the
    # inputs the main path gave it (the n=100 LP)
    args, kwargs = recorded[0]
    mk_s, out_k = sync_time(lambda: mk.solve_mega_cuda(*args, **kwargs), 3)
    pl_s, out_p = sync_time(lambda: mk.solve_mega_plain(*args, **kwargs), 3)
    check(out_k[3] == out_p[3] == tt.SolverStatus.CONVERGED,
          f"megakernel status {out_k[3]}, plain {out_p[3]}")
    mk_err = float((out_k[0][0] / out_k[0][3] - out_p[0][0] / out_p[0][3])
                   .abs().max())
    scale = float((out_p[0][0] / out_p[0][3]).abs().max())
    check(mk_err <= 1e-3 * max(1.0, scale),
          f"megakernel x/tau differs from plain by {mk_err:.3e}")

    record = {"kernels": [
        {"name": "dual_matvec", "route": "cuda",
         "source": "totsu_tpu_torch/csrc/dual_matvec.cu",
         "replaces": "totsu_tpu/ops/pallas/dual_matvec.py:54",
         "launches": main_counts["dual_matvec"],
         "max_abs_err": dm_err[(4000, 1000, str(torch.float32))],
         "ms": times[str(torch.float32)][0],
         "plain_ms": times[str(torch.float32)][1]},
        {"name": "megakernel", "route": "cuda",
         "source": "totsu_tpu_torch/csrc/megakernel.cu",
         "replaces": "totsu_tpu/ops/pallas/megakernel.py:184",
         "launches": main_counts["megakernel"],
         "max_abs_err": mk_err, "ms": 1e3 * mk_s, "plain_ms": 1e3 * pl_s},
    ]}
    print(f"megakernel vs plain on the n=100 LP inputs: {out_k[2]}/"
          f"{out_p[2]} iterations, {1e3 * mk_s:.2f}/{1e3 * pl_s:.2f} ms, "
          f"max |x err| {mk_err:.3e}", flush=True)
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
