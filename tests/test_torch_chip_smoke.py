"""The parts of ``chip_smoke.py`` that run without a card.

The smoke script copies two examples' problem builders as numpy code (it
imports nothing of the JAX package); here they are held to the examples'
own builders, exactly. Its instance generators, references and bound
arithmetic run on the CPU at small sizes, and the script refuses to run
without a CUDA device.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from totsu_tpu_torch.ops.kernels import cone_proj as cp
# one thread per pool: this module's problems are small, and beside five
# busy workers the pools oversubscribe the cores (the module ran ten
# times slower)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))




def _spec(layout):
    return [(f.kind, f.dim, f.count, f.alpha) for f in layout.factors]


def test_make_logreg_is_the_example_build():
    import logreg_expcone
    import totsu_tpu_torch as tt
    x, y, c, a, b, spec = cs.make_logreg(24, 6, 0.1)
    cj, aj, bj, lay = logreg_expcone.build(x, y, 0.1)
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(a, aj)
    np.testing.assert_array_equal(b, bj)
    assert _spec(cs.cone(tt, spec)) == _spec(lay)
    # the example's data generator (its main, seed 3)
    rng = np.random.default_rng(3)
    w_true = np.concatenate([rng.normal(size=3) * 2.0, np.zeros(3)])
    xe = rng.normal(size=(24, 6))
    ye = np.where(xe @ w_true + 0.3 * rng.normal(size=24) > 0, 1.0, -1.0)
    np.testing.assert_array_equal(x, xe)
    np.testing.assert_array_equal(y, ye)


def test_make_growth_is_the_example_build():
    import growthport_powexp
    import totsu_tpu_torch as tt
    returns, c, a, b, spec, root = cs.make_growth(8, 6, -1.2)
    cj, aj, bj, lay, root_j = growthport_powexp.build_problem(returns, -1.2)
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(a, aj)
    np.testing.assert_array_equal(b, bj)
    assert root == root_j
    assert _spec(cs.cone(tt, spec)) == _spec(lay)


def test_references_at_small_size():
    # the oracles agree with the port's f64 solves on small instances, to
    # 1e-3 relative (eps_acc 1e-5 bounds the residuals and the gap)
    import totsu_tpu_torch as tt
    from totsu_tpu_torch import interop
    param = tt.SolverParam(max_iter=200_000, eps_acc=1e-5)
    x, y, c, a, b, spec = cs.make_logreg(24, 6)
    r = tt.solve(*interop.problem_from_numpy(c, a, b, device="cpu"),
                 cs.cone(tt, spec), param)
    obj = cs.logreg_objective(x, y, r.x[:6].numpy(), 0.1)
    assert abs(obj - cs.logreg_reference(x, y, 0.1)) <= 1e-3 * abs(obj)
    term_c, term_a = cs.make_gp_terms(n=6, n_con=4)
    prob, meta = tt.problems.gp(term_c, term_a, device="cpu")
    r = prob.solve(param)
    f0 = np.sum(term_c[0] * np.prod(np.exp(r.x[:6].numpy())[None, :]
                                    ** term_a[0], axis=1))
    assert abs(f0 - cs.gp_reference(term_c, term_a)) <= 1e-3 * f0
    returns, c, a, b, spec, root = cs.make_growth(4, 6, -1.2)
    r = tt.solve(*interop.problem_from_numpy(c, a, b, device="cpu"),
                 cs.cone(tt, spec), param)
    g_ref = cs.growth_reference(returns, -1.2)
    assert abs(float(r.x[root]) - g_ref) <= 1e-3 * g_ref


@pytest.mark.parametrize("kind,alpha", [("exp", 0.5), ("pow", 0.1),
                                        ("pow", 0.9)])
def test_cone_blocks_cover_every_case(kind, alpha):
    # a fifth each: random, in the cone, in the polar, in the negative
    # quadrant, on the boundary; the projection keeps the cone points,
    # zeroes the polar points and moves the others
    rng = np.random.default_rng(0)
    blocks = cs.cone_blocks(kind, 500, rng, alpha)
    xb = torch.from_numpy(blocks)
    out = cp.cone_proj(xb, kind, alpha).numpy()
    inside, polar = slice(100, 200), slice(200, 300)
    np.testing.assert_allclose(out[inside], blocks[inside], rtol=1e-12)
    assert np.all(out[polar] == 0.0)
    scale = np.abs(blocks).max(1)
    assert np.all(np.abs(out[300:400] - blocks[300:400]).max(1)
                  > 1e-6 * scale[300:400])
    assert scale.min() < 1e-4 and scale.max() > 1e4


def test_cone_proj_ops_counts_the_trips():
    # the counting pass leaves the result alone and counts each block's
    # trips until its state stops changing: in the cone, no trip
    rng = np.random.default_rng(2)
    xb = torch.from_numpy(cs.cone_blocks("exp", 100, rng))
    before = cp.cone_proj(xb, "exp")
    ops = cs.cone_proj_ops(xb, "exp", 0.0, False)
    torch.testing.assert_close(cp.cone_proj(xb, "exp"), before, rtol=0,
                               atol=0)
    assert ops > 100 * cs.OPS_EXP_BLOCK
    inside = torch.tensor([[0.0, 1.0, 2.0]] * 10, dtype=torch.float64)
    assert cs.cone_proj_ops(inside, "exp", 0.0, False) \
        == 10 * cs.OPS_EXP_BLOCK
    assert cs.cone_proj_ops(inside, "pow", 0.5, False) \
        > 10 * cs.OPS_POW_BLOCK  # (0, 1, 2) is outside the pow cone


def test_bound_arithmetic():
    # dual_matvec at 4000 x 1000 f32: A's 16 MB over 3.35 TB/s, 4.8 us
    ms, by = cs.bound_ms(4 * 4000 * 1000, 4 * 4000 * 1000)
    assert by == "bytes" and abs(ms - 16e6 / 3.35e12 * 1e3) < 1e-9
    ms, by = cs.bound_ms(1000, 67e9)
    assert by == "operations" and abs(ms - 1.0) < 1e-12


def test_make_lp_is_bench_make_lp():
    # phase 13's n=4000 LP comes from the benchmark's generator: the same
    # arrays at a small n (A (4n, n): 2n random rows and the box)
    sys.path.insert(0, cs.ROOT)
    import bench
    for n in (5, 12):
        for got, want in zip(cs.make_lp(n), bench.make_lp(n)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        assert cs.make_lp(n)[1].shape == (4 * n, n)


def test_lp_kkt_passes_the_solution_and_fails_a_perturbed_one():
    # the golden LP: x* = (2, 2), y* = (4/15, 1/15, 0) (A^T y* = -c,
    # b^T y* = 2 = -c^T x*); phase 13's bound is 2e-3 on each residual
    c = np.array([-1.0, 0.0])
    a = np.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = np.array([6.0, 6.0, 1.0])
    x, y = np.array([2.0, 2.0]), np.array([4.0, 1.0, 0.0]) / 15.0
    assert max(cs.lp_kkt(c, a, b, x, y)) <= 1e-15
    pri, dual, gap = cs.lp_kkt(c, a, b, x + [0.1, 0.0], y)
    assert pri > 2e-3 and gap > 2e-3 and dual <= 1e-15
    assert cs.lp_kkt(c, a, b, x, y - [0.0, 0.0, 0.01])[1] > 2e-3
    assert cs.lp_kkt(c, a, b, x, y * 1.01)[1] > 2e-3


def test_drive_counts_each_path_from_zero():
    kern = type("K", (), {"launches": 7})()

    def run(k):
        def go():
            kern.launches += k
            spans.append(("step", 0.0, k))
            return type("R", (), {"status": 1, "iters": k})()
        return go

    spans = ["stale"]
    torch_sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **kw: None
    try:
        runs = cs.drive({"one": run(1), "two": run(2)}, {"k": kern}, spans)
    finally:
        torch.cuda.synchronize = torch_sync
    assert runs["one"][2] == {"k": 1} and runs["two"][2] == {"k": 2}
    assert runs["two"][3] == [("step", 0.0, 2)]


def test_time_calls_records_and_restores():
    import types
    mod = types.SimpleNamespace(f=lambda x: 2 * x)
    spans = []
    torch_sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **kw: None
    try:
        real = cs.time_calls(mod, ("f",), spans)
        assert mod.f(3) == 6
    finally:
        torch.cuda.synchronize = torch_sync
    assert [(n, out) for n, _, out in spans] == [("f", 6)]
    assert cs.span_ms(spans, "f") >= 0.0 and cs.span_ms(spans, "g") == 0.0
    mod.f = real["f"]
    assert mod.f(2) == 4


def test_smoke_refuses_without_cuda(tmp_path):
    # no card: a non-zero exit and no result line; alone in a directory
    # (without the repository): the same
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['chip_smoke.py']; sys.path.insert(0, {cs.ROOT!r}); "
            "import chip_smoke; chip_smoke.main()")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(cs.__file__).read())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_mega_timing_refuses_without_cuda():
    script = os.path.join(cs.ROOT, "mega_timing.py")
    code = ("import sys, runpy, torch; torch.cuda.is_available = "
            f"lambda: False; sys.argv = [{script!r}]; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_dm_timing_refuses_without_cuda():
    script = os.path.join(cs.ROOT, "dm_timing.py")
    code = ("import sys, runpy, torch; torch.cuda.is_available = "
            f"lambda: False; sys.argv = [{script!r}, '--cut']; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_dm_timing_cut_point_is_in_the_kernel():
    # --cut stops the kernel after the partials' stores; the statement it
    # cuts at must stay in the source, once
    import runpy
    from totsu_tpu_torch.ops.kernels import _build
    script = runpy.run_path(os.path.join(cs.ROOT, "dm_timing.py"))
    src = (_build.CSRC / "dual_matvec.cu").read_text()
    assert src.count(script["CUT_AT"]) == 1


def test_device_ms_survives_lost_records(monkeypatch):
    # each kernel at its mean per record times its records per call
    # (rounded up), so a window that lost records reads as a whole one;
    # CPU rows and empty windows do not count; the median of the windows
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    windows = iter([
        [(cuda, 50, 440.0), (cuda, 100, 300.0), (cpu, 50, 900.0)],
        [(cuda, 33, 290.4), (cuda, 60, 180.0)],  # records lost
        [],
        [(cuda, 50, 450.0), (cuda, 100, 310.0)],
        [(cuda, 50, 430.0), (cuda, 100, 290.0)],
    ])

    class Row:
        def __init__(self, kind, count, us):
            self.device_type, self.count = kind, count
            self.self_device_time_total = us

    class Prof:
        def __init__(self, activities):
            self.rows = [Row(*r) for r in next(windows)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.rows

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    # per call: 14.8, 14.8, none, 15.2, 14.4 us
    assert cs.device_ms(lambda: None, calls=50) == pytest.approx(0.0148)


def test_dm_times_orders_and_formats(monkeypatch):
    # the three versions in turns (library, kernel, kernel, library,
    # plain) under both timers; the kernel's share of the byte bound
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    calls = []

    class Fake:
        dual_matvec_plain = staticmethod(dm.dual_matvec_plain)

        @staticmethod
        def dual_matvec_cuda(a, u, v):
            calls.append("kernel")
            return dm.dual_matvec_plain(a, u, v)

    readings = iter([0.014, 0.008, 0.010, 0.016, 0.02,
                     0.017, 0.009, 0.011, 0.018, 0.03])
    monkeypatch.setattr(cs, "device_ms", lambda f: (f(), next(readings))[1])
    monkeypatch.setattr(cs, "stream_ms", lambda f: (f(), next(readings))[1])
    a, u, v = torch.randn(400, 100), torch.randn(100), torch.randn(400)
    t = cs.dm_times(Fake, a, u, v)
    assert len(calls) == 4  # two kernel readings under each timer
    assert t["device"] == pytest.approx((0.009, 0.02, 0.015))
    assert t["events"] == pytest.approx((0.01, 0.03, 0.0175))
    bytes_ = 4 * 400 * 100 + 4 * 2 * 500
    assert t["bound"] == cs.bound_ms(bytes_, 4 * 400 * 100)
    line = cs.fmt_dm_times("x", t)
    assert "9.00/20.00/15.00" in line and "kernel <= library" in line
    assert f"{100 * t['bound'][0] / 0.009:.1f}%" in line


def test_mega_phases_marks_are_in_the_kernel():
    # every timer of mega_phases.py finds its place in the kernel once,
    # and the copy keeps the kernel's entry points
    import runpy
    from totsu_tpu_torch.ops.kernels import _build
    script = runpy.run_path(os.path.join(cs.ROOT, "mega_phases.py"))
    src = (_build.CSRC / "megakernel.cu").read_text()
    out = script["patched"](src)
    marks = script["MARKS"]
    assert out.count("PHASE(") == len(marks) + 1  # the macro's definition
    assert sorted(k for _, k, _ in marks) == list(range(len(marks)))
    assert "int totsu_mega_solve(" in out and "totsu_phases" in out


def test_mega_phases_refuses_without_cuda():
    script = os.path.join(cs.ROOT, "mega_phases.py")
    code = ("import sys, runpy, torch; torch.cuda.is_available = "
            f"lambda: False; sys.argv = [{script!r}]; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_mega_timing_sweeps_every_cell():
    import runpy
    script = runpy.run_path(os.path.join(cs.ROOT, "mega_timing.py"))
    assert set(script["SWEEP"]) == set(script["CELLS"])


def test_cone_proj_trips_counts_the_longest_chain():
    # per loop the trips of all blocks; the chain is the most one block
    # takes over its loops, as a block run alone shows
    rng = np.random.default_rng(4)
    xb = torch.from_numpy(cs.cone_blocks("exp", 40, rng))
    totals, chain = cs.cone_proj_trips(xb, "exp", 0.0, False)
    assert len(totals) == 2 and 0 < chain <= sum(totals)
    alone = [sum(cs.cone_proj_trips(xb[i:i + 1], "exp", 0.0, False)[0])
             for i in range(40)]
    assert chain == max(alone)
    inside = torch.tensor([[0.0, 1.0, 2.0]] * 3, dtype=torch.float64)
    assert cs.cone_proj_trips(inside, "exp", 0.0, False) == ([], 0)
    pw = torch.from_numpy(cs.cone_blocks("pow", 40, rng, 0.3))
    totals, chain = cs.cone_proj_trips(pw, "pow", 0.3, True)
    assert len(totals) == 1 and 0 < chain <= totals[0]


def test_cone_eval_latency_divides_by_the_chain(monkeypatch):
    # clocks and ms per evaluation: the chain's clocks and its events time
    # over its length, per kind and dtype, after a warm-up call
    calls = []

    class FakeCp:
        @staticmethod
        def eval_clocks(kind, dtype, evals, device):
            calls.append((kind, dtype, evals))
            return 300 * evals

    class Event:
        t = 0.0

        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            Event.t += 2.0
            self.at = Event.t

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return other.at - self.at

    monkeypatch.setattr(torch.cuda, "Event", Event)
    out = cs.cone_eval_latency(FakeCp, "cuda", evals=1000)
    assert set(out) == {(k, str(d)) for k in ("exp", "pow")
                        for d in (torch.float32, torch.float64)}
    assert all(v == pytest.approx((300.0, 0.002)) for v in out.values())
    assert calls[:2] == [("exp", torch.float32, 10),
                         ("exp", torch.float32, 1000)]


def test_cone_proj_floor_is_the_model_chain_times_the_latency():
    rng = np.random.default_rng(5)
    xb = torch.from_numpy(cs.cone_blocks("exp", 100, rng)).float()
    latency = {("exp", str(torch.float32)): (250.0, 1e-4)}
    chain, serial, floor = cs.cone_proj_floor(cp, xb, "exp", 0.0, False,
                                              latency)
    assert chain == int(cp._lane_model(xb, "exp", 0.0, False)[1].max())
    assert serial == cs.cone_proj_trips(xb, "exp", 0.0, False)[1]
    assert 0 < chain < serial and floor == pytest.approx(chain * 1e-4)


def test_cp_timing_refuses_without_cuda():
    script = os.path.join(cs.ROOT, "cp_timing.py")
    code = ("import sys, runpy, torch; torch.cuda.is_available = "
            f"lambda: False; sys.argv = [{script!r}]; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_ref_overlap_timing_refuses_without_cuda():
    script = os.path.join(cs.ROOT, "ref_overlap_timing.py")
    code = ("import sys, runpy, torch; torch.cuda.is_available = "
            f"lambda: False; sys.argv = [{script!r}]; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=cs.ROOT)
    assert out.returncode != 0 and "no CUDA device" in out.stderr



def _small_lp(n=8, seed=1):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    a = np.concatenate([g, np.eye(n), -np.eye(n)])
    b = np.concatenate([h, np.full(2 * n, 10.0)])
    return [torch.tensor(x) for x in (rng.normal(size=n), a, b)] \
        + [4 * n]


@pytest.mark.parametrize("accel", ["", "halpern", "restart"])
def test_split_solve_is_bitwise_on_the_cpu(accel):
    # phase 17's split: k iterations, then k more from the checkpoint,
    # against one solve of 2k, k rounded down to the check period; asked
    # for a k past half the golden LP's run (160 or 200 iterations), the
    # split moves inside it
    import totsu_tpu_torch as tt
    c, a, b = (torch.tensor(x, dtype=torch.float64) for x in (
        [-1.0, 0.0], [[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]],
        [6.0, 6.0, 1.0]))
    cone = tt.ConeLayout([tt.rpos(3)])

    def solve(p, **kw):
        return tt.solve_jit(c, a, b, cone, p, **kw)

    p = tt.SolverParam(check_period=20, eps_acc=1e-6, accel=accel)
    k, whole, first, second = cs.split_solve(solve, p, k=50)
    assert k == 40 and whole.status == tt.SolverStatus.EXCESS_ITER
    assert cs.bitwise_diff(second, whole) == []
    assert second.state.k == whole.state.k == 80
    full = solve(dataclasses_replace(p, max_iter=100_000))
    assert full.converged
    k, whole, first, second = cs.split_solve(solve, p, k=full.iters)
    assert 0 < k and 2 * k < full.iters and k % 20 == 0
    assert first.status == second.status == tt.SolverStatus.EXCESS_ITER
    assert cs.bitwise_diff(second, whole) == []


def dataclasses_replace(p, **kw):
    import dataclasses
    return dataclasses.replace(p, **kw)


def test_bitwise_diff_names_the_fields():
    import dataclasses
    import totsu_tpu_torch as tt
    c, a, b, m = _small_lp()
    r = tt.solve_jit(c, a, b, tt.ConeLayout([tt.rpos(m)]),
                     tt.SolverParam(max_iter=40))
    assert cs.bitwise_diff(r, r) == []
    nudged = dataclasses.replace(r, x=r.x.clone(), cri_gap=r.cri_gap + 0.0,
                                 status=1)
    nudged.x[0] = torch.nextafter(nudged.x[0], torch.tensor(np.inf,
                                                            dtype=r.x.dtype))
    assert cs.bitwise_diff(nudged, r) == ["status", "x"]


def test_log_ks_reads_back_the_loop_s_lines(capfd):
    # phase 19's gate: one line per logged check, each parsed back to the
    # k of the check, for a run that starts at 0 and one resumed at 60
    import totsu_tpu_torch as tt
    c, a, b, m = _small_lp()
    cone = tt.ConeLayout([tt.rpos(m)])
    p = tt.SolverParam(max_iter=400, check_period=20, log_period=50,
                       accel="halpern", return_state=True)
    tt.solve_jit(c, a, b, cone, p)
    got = cs.log_ks(capfd.readouterr().out)
    assert got == cs.logged_ks(400, 20, 50)
    assert got == [20, 80, 120, 180, 220, 280, 320, 380]
    part = tt.solve_jit(c, a, b, cone, dataclasses_replace(p, max_iter=60))
    capfd.readouterr()
    tt.solve_jit(c, a, b, cone, p, resume_state=part.state)
    assert cs.log_ks(capfd.readouterr().out) == cs.logged_ks(
        400, 20, 50, k_start=60)
    assert cs.log_ks("x\n20: res 1.00e-02 (restart=False)\n 40: no\n") \
        == [20]


def test_spd_cache_counted_once_in_a_chunked_direct_solve():
    # phase 18's gate, on the CPU: time_calls wraps the module function,
    # and a chunked solve builds the cache once
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.solver import direct as tdirect
    c, a, b, m = _small_lp()
    spans = []
    torch_sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a_, **kw: None
    real = cs.time_calls(tdirect, ("spd_cache", "_run_halpern_dr"), spans)
    try:
        r = tt.solve(c, a, b, tt.ConeLayout([tt.rpos(m)]),
                     tt.SolverParam(max_iter=100_000, method="direct",
                                    accel="halpern", check_period=20),
                     chunk_iters=40)
    finally:
        for name, fn in real.items():
            setattr(tdirect, name, fn)
        torch.cuda.synchronize = torch_sync
    chunks = sum(1 for n, _, _ in spans if n == "_run_halpern_dr")
    assert r.converged and chunks == -(-r.iters // 40) > 1
    assert sum(1 for n, _, _ in spans if n == "spd_cache") == 1


# ---- phases 20-22: the structured operators and the indirect engine


def _benchmarks():
    path = os.path.join(cs.ROOT, "benchmarks")
    if path not in sys.path:
        sys.path.insert(0, path)


def test_make_banded_box_lp_is_the_benchmark_s():
    # phases 21-22's n = 4096 box LP comes from benchmark_indirect.py's
    # generator: the same arrays at n = 512
    _benchmarks()
    import benchmark_indirect
    for got, want in zip(cs.make_banded_box_lp(512),
                         benchmark_indirect.make_banded_box_lp(512)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_make_banded_lp_is_the_benchmark_s():
    _benchmarks()
    import benchmark_sparse
    for got, want in zip(cs.make_banded_lp(512, k_tiles=2),
                         benchmark_sparse.make_banded_lp(512, k_tiles=2)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("adjoint", [True, False], ids=["hand", "autograd"])
def test_stencil_op_is_the_benchmark_s(adjoint):
    # phase 22's matrix-free stencil LP: the torch copy of the JAX
    # benchmark's operator and LP, in f32, to f32 roundoff (1e-6); the
    # adjoint written by hand or left to autograd
    _benchmarks()
    import jax.numpy as jnp
    import benchmark_indirect as bi
    import totsu_tpu_torch as tt
    n = 64
    ours = cs.make_stencil_op(tt, n, "cpu", adjoint=adjoint)
    theirs = bi.make_stencil_op(n)
    rng = np.random.default_rng(0)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=3 * n).astype(np.float32)
    for got, want in (
            (ours.matvec(torch.from_numpy(x)), theirs.matvec(jnp.asarray(x))),
            (ours.rmatvec(torch.from_numpy(y)),
             theirs.rmatvec(jnp.asarray(y))),
            (ours.col_abssum(), theirs.col_abssum()),
            (ours.row_abssum(), theirs.row_abssum())):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    c, _, b = cs.make_stencil_lp(tt, n, "cpu", adjoint=adjoint)
    cj, _, bj = bi.make_stencil_lp(n)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=0)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), atol=1e-6)


def test_tiles_lp_is_jax_from_tiles():
    # phase 20's generator at n = 512 (bench.py's n = 65,536 LP cut to 4
    # tile rows): the port's BlockedEllOp from its tiles holds the JAX
    # package's arrays, and the host's sparse copy of [band; I; -I] is its
    # dense form
    import totsu_tpu as jt
    import totsu_tpu_torch as tt
    tiles, b, c = cs.make_tiles_lp(512)
    assert sorted(tiles) == [(0, 0), (0, 1), (1, 0), (1, 1), (1, 2), (2, 1),
                             (2, 2), (2, 3), (3, 2), (3, 3)]
    assert b.shape == (1536,) and c.shape == (512,)
    assert b.dtype == c.dtype == np.float32
    ours = tt.BlockedEllOp.from_tiles(tiles, m=512, n=512, block=(128, 128),
                                      device="cpu")
    theirs = jt.BlockedEllOp.from_tiles(tiles, m=512, n=512,
                                        block=(128, 128))
    np.testing.assert_array_equal(ours.blocks.permute(0, 2, 1, 3).numpy(),
                                  np.asarray(theirs.blocks))
    np.testing.assert_array_equal(ours.blocks_t.permute(0, 2, 1, 3).numpy(),
                                  np.asarray(theirs.blocks_t))
    np.testing.assert_array_equal(ours.cols.numpy(), np.asarray(theirs.cols))
    np.testing.assert_array_equal(ours.cols_t.numpy(),
                                  np.asarray(theirs.cols_t))
    band = np.asarray(theirs.to_dense())
    want = np.concatenate([band, np.eye(512), -np.eye(512)])
    np.testing.assert_array_equal(cs.tiles_box_csr(tiles, 512, 128).toarray(),
                                  want)


def test_sparse_lp_kkt_passes_a_solution_and_fails_a_perturbed_one():
    # phase 20's residuals from the sparse host copy, never dense: the
    # numbers of the dense formula, within 2e-3 for a solve at eps_acc 1e-3
    # on the CPU, past it for a perturbed x or y
    import totsu_tpu_torch as tt
    tiles, b, c = cs.make_tiles_lp(256)
    a_sp = cs.tiles_box_csr(tiles, 256, 128)
    ell = tt.BlockedEllOp.from_tiles(tiles, m=256, n=256, block=(128, 128),
                                     device="cpu")
    ones = torch.ones(256)
    a_op = tt.VStackOp((ell, tt.DiagOp(ones), tt.DiagOp(-ones)))
    r = tt.solve(torch.from_numpy(c), a_op, torch.from_numpy(b),
                 tt.ConeLayout([tt.rpos(768)]),
                 tt.SolverParam(max_iter=8000, eps_acc=1e-3, check_period=20,
                                method="direct", accel="halpern"))
    x, y = r.x.numpy(), r.y.numpy()
    kkt = cs.lp_kkt(c, a_sp, b, x, y)
    assert max(kkt) <= 2e-3
    np.testing.assert_allclose(kkt, cs.lp_kkt(c, a_sp.toarray(), b, x, y),
                               rtol=1e-9)
    assert cs.lp_kkt(c, a_sp, b, x + 0.1, y)[0] > 2e-3
    assert cs.lp_kkt(c, a_sp, b, x, y * 1.1)[1] > 2e-3


def test_structured_phases_run_on_the_cpu_at_a_small_size(monkeypatch,
                                                          capsys):
    # phases 20-22's flow (every solve, gate and line) at n = 256 on the
    # CPU, with the card's timers stubbed: it launches none of the three
    # kernels
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    from totsu_tpu_torch.ops.kernels import megakernel as mk

    def timed(fn, **kw):
        fn()
        return 1e-3

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(cs, "device_ms", timed)
    monkeypatch.setattr(cs, "stream_ms", timed)
    monkeypatch.setattr(cs, "kernel_rows",
                        lambda fn, **kw: (fn(), [("gemv", 30.0)])[1])
    monkeypatch.setattr(cs, "profile_loop",
                        lambda fn, iters: (fn(), (1.0, 0.5, 9.0, []))[1])
    kernels = {"dual_matvec": dm, "megakernel": mk, "cone_proj": cp}
    counts = cs.structured_phases(tt, torch.device("cpu"), kernels, n20=256,
                                  n21=256, n21b=256, n22=256,
                                  pdhg_iters=200)
    assert counts == {k: 0 for k in kernels}
    out = capsys.readouterr().out
    for phase in (20, 21, 22):
        assert f"\nphase {phase} " in out
    assert "bitwise the whole solve" in out


def test_operator_errors_catches_a_wrong_operator():
    import totsu_tpu_torch as tt
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 4)).astype(np.float32)
    good = tt.DenseOp(torch.from_numpy(a))
    errs = cs.operator_errors(good, a, rng)
    assert set(errs) == {"to_dense", "matvec", "rmatvec", "col_abssum",
                         "row_abssum", "row_absmax", "col_absmax",
                         "col_sqsum", "diag_scale"}
    assert max(errs.values()) <= 1e-6

    class Off(tt.DenseOp):
        def rmatvec(self, y):
            return super().rmatvec(y) * 1.001

    bad = cs.operator_errors(Off(torch.from_numpy(a)), a, rng)
    assert bad["rmatvec"] > 1e-4 and bad["matvec"] <= 1e-6


def test_kernel_rows_survive_lost_records(monkeypatch):
    # phase 20's rows of the ELL product: each kernel at its mean per
    # record times its records per call, so a window that lost records
    # reads as a whole one; CPU rows do not count
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    class Row:
        def __init__(self, key, kind, count, us):
            self.key, self.device_type, self.count = key, kind, count
            self.self_device_time_total = us

    class Prof:
        def __init__(self, activities):
            self.rows = [Row("gather", cuda, 20, 50.0),
                         Row("gemv", cuda, 3, 108.0),    # 17 records lost
                         Row("launch", cpu, 20, 900.0)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.rows

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert cs.kernel_rows(lambda: None, calls=20) == [
        ("gemv", pytest.approx(36.0)), ("gather", pytest.approx(2.5))]


# ---- phases 23-26: the SDP, SOCP and QCQP examples' builders, copied as
# numpy, and the phases' flow at a small size


def test_pack_index_is_sympack_s():
    from totsu_tpu_torch.ops import sympack
    for k in (1, 2, 5, 48):
        rr, cc = cs.pack_index(k)
        want = sympack._pack_index(k)
        np.testing.assert_array_equal(rr, want[0])
        np.testing.assert_array_equal(cc, want[1])
    x = np.arange(1.0, 7.0)
    np.testing.assert_array_equal(cs.packed_matrix(x, 3), [[1, 2, 4],
                                                           [2, 3, 5],
                                                           [4, 5, 6]])


def test_make_partitioning_is_the_example_build():
    # the example's W, and the data its solve_sdp hands to problems.sdp
    import partitioning_sdp
    import totsu_tpu as jt
    w, c, f_mats, a, b = cs.make_partitioning(4, 3)
    np.testing.assert_array_equal(w, partitioning_sdp.build(4, 3))
    seen = {}

    class Spy:
        class problems:
            @staticmethod
            def sdp(*args):
                seen["args"] = args
                return jt.problems.sdp(*args)

    partitioning_sdp.solve_sdp(w, Spy, jt.SolverParam(max_iter=1))
    for got, want in zip((c, f_mats, a, b), seen["args"]):
        np.testing.assert_array_equal(got, want)


def test_make_partitioning_structured_is_the_benchmark_build():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "benchmarks"))
    import benchmark_sdp
    for l in (8, 12, 48):
        w, c, neg_d, sel, b = cs.make_partitioning_structured(l)
        cj, aj, bj, wj = benchmark_sdp.build_partitioning(l)
        np.testing.assert_array_equal(w, wj)
        np.testing.assert_array_equal(c, np.asarray(cj))
        np.testing.assert_array_equal(b, np.asarray(bj))
        np.testing.assert_array_equal(neg_d, np.asarray(aj.ops[0].d))
        np.testing.assert_array_equal(sel, np.asarray(aj.ops[1].a))
    # the benchmark's k = 48 graph is the example's 8 x 6 grid
    np.testing.assert_array_equal(cs.make_partitioning_structured(48)[0],
                                  cs.make_partitioning(8, 6)[0])


def test_nearestcorr_is_the_example_build():
    import jax.numpy as jnp
    import nearestcorr_batch_sdp
    from totsu_tpu.ops import sympack
    np.testing.assert_array_equal(cs.make_noisy_covs(3, 5),
                                  nearestcorr_batch_sdp.make_noisy_covs(3, 5))
    a, c, sn = cs.nearestcorr_data(5)
    aj, cj, lay, diag_pos, snj = nearestcorr_batch_sdp.build(5, jnp.float64)
    assert sn == snj
    np.testing.assert_array_equal(a, np.asarray(aj))
    np.testing.assert_array_equal(c, np.asarray(cj))
    assert [(f.kind, f.dim, f.count) for f in lay.factors] == [
        ("soc", 1 + sn, 1), ("psd", sn, 1), ("zero", 5, 1)]
    s = cs.make_noisy_covs(1, 5)[0]
    want = np.concatenate([[0.0], -np.asarray(sympack.pack(
        jnp.asarray(s), scaled=True)), np.zeros(sn), np.ones(5)])
    np.testing.assert_allclose(cs.nearestcorr_b(s), want, rtol=1e-15)


def test_make_trajplan_and_torus_are_the_example_builds():
    import toruscompl_socp
    import trajplan_qcqp
    got = cs.make_trajplan(12, 300.0)
    want = trajplan_qcqp.build(12, 300.0)
    for g, w in zip(got, want[:5]):
        np.testing.assert_array_equal(g, w)
    got = cs.make_torus(5, 4)
    want = toruscompl_socp.build(5, 4)
    for g, w in zip(got[:7], want[:7]):
        if isinstance(g, list):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                np.testing.assert_array_equal(gi, wi)
        else:
            np.testing.assert_array_equal(g, w)
    assert got[7] == want[7]
    np.testing.assert_array_equal(got[8], want[8])


def test_cpu_references_at_small_size():
    ref = cs.cpu_references(lp_n=40, grid24=(4, 2), torus=(5, 4),
                            traj=(12, 300.0))
    assert ref["partitioning_status"] == ref["torus_status"] == 1
    assert ref["traj_viol"] <= 1e-6
    # HiGHS on the n = 40 benchmark LP, as phase 4 reads it
    from scipy.optimize import linprog
    c, a, b = cs.make_lp(40)
    hi = linprog(c.astype(np.float64), A_ub=a.astype(np.float64),
                 b_ub=b.astype(np.float64), bounds=(None, None),
                 method="highs")
    assert ref["lp"]["status"] == 0 and ref["lp"]["fun"] == hi.fun
    np.testing.assert_array_equal(ref["lp"]["x"], hi.x)
    # the dense form of the same SDP agrees with the structured reference
    import totsu_tpu_torch as tt
    w, c, f_mats, a, b = cs.make_partitioning(4, 2)
    r = tt.problems.sdp(c, f_mats, a, b, device="cpu").solve(
        tt.SolverParam(max_iter=100_000, eps_acc=1e-6, profile="fast"))
    obj = float(np.trace(w @ cs.packed_matrix(r.x.numpy(), 8)))
    assert abs(obj - ref["partitioning"]) <= 1e-4 * abs(obj)


def test_cpu_references_run_in_a_child_without_the_card():
    child = cs.start_cpu_references(lp_n=20, grid24=[2, 2], torus=[3, 2],
                                    traj=[6, 300.0])
    out, err = child.communicate(timeout=300)
    assert child.returncode == 0, err
    import json
    ref = json.loads(out.strip().splitlines()[-1])
    assert set(ref) >= {"lp", "partitioning", "torus", "traj"}


def test_cpu_references_child_runs_on_its_own_cores():
    import json
    import os
    core = max(os.sched_getaffinity(0))
    child = cs.start_cpu_references(lp_n=20, grid24=[2, 2], torus=[3, 2],
                                    traj=[6, 300.0], cores=[core])
    out, err = child.communicate(timeout=300)
    assert child.returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1])["cores"] == [core]


def test_sdp_phases_run_on_the_cpu_at_a_small_size(monkeypatch, capsys):
    # phases 23-26's flow (every solve, gate and line) at small sizes on
    # the CPU, the card's timers stubbed and kernel J's launch standing in
    # for its plain version (counted as a launch)
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj

    def timed(fn, *args, **kw):
        fn()
        return 1e-3

    def launch(v, scaled=True, sweeps=None):
        pj.launches += 1
        return pj.proj_psd_jacobi_plain(v, scaled, sweeps)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(cs, "device_ms", timed)
    monkeypatch.setattr(cs, "stream_ms", timed)
    monkeypatch.setattr(cs, "profile_loop",
                        lambda fn, iters: (fn(), (1.0, 0.5, 9.0, []))[1])
    monkeypatch.setattr(pj, "proj_psd_jacobi_cuda", launch)
    monkeypatch.setattr(pj, "proj_psd_jacobi",
                        lambda v, scaled=True, sweeps=None: launch(
                            v.reshape(-1, v.shape[-1]), scaled,
                            sweeps).reshape(v.shape))
    # the trajectory QCQP needs some 10^5 iterations at any size that is
    # feasible; its flow runs on min 0.5 |x|^2, |x| <= cap, x1 + x2 = 1
    monkeypatch.setattr(cs, "make_trajplan", lambda t_cap, a_cap: (
        np.stack([np.eye(2), np.eye(2)]), np.zeros((2, 2)),
        np.array([0.0, -0.5 * a_cap * a_cap]), np.ones((1, 2)),
        np.ones(1)))
    kernels = {"dual_matvec": dm, "megakernel": mk, "cone_proj": cp,
               "psd_jacobi": pj}
    kw = dict(grid24=(4, 2), torus=(5, 4), traj=(12, 2.0))
    counts, record = cs.sdp_phases(
        tt, torch.device("cpu"), kernels,
        lambda: cs.cpu_references(lp_n=20, **kw),
        shapes23=((4, 3), (5, 2)), ks25=(6, 8, 10), iters25=(10, 6),
        prof_iters25=4, cov=(1, 4), **kw)
    assert counts["psd_jacobi"] > 0 and counts["megakernel"] == 0
    assert record["launches"] == counts["psd_jacobi"]
    assert set(record) >= {"name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms"}
    out = capsys.readouterr().out
    for phase in (23, 24, 25, 26):
        assert f"\nphase {phase} " in out


def test_polish_diff_phases_run_on_the_cpu_at_a_small_size(monkeypatch,
                                                           capsys):
    # phases 27-28's flow (every solve, gate and line) at small sizes on
    # the CPU, with the card's timers stubbed; the references are the
    # child's, at the same sizes
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(cs, "profile_loop",
                        lambda fn, iters: (fn(), (1.0, 0.5, 9.0, []))[1])
    refs = cs.cpu_references(lp_n=60, grid24=(3, 2), torus=(3, 2),
                             traj=(6, 90.0), grid27=(2, 2))
    torch.set_num_threads(1)     # cpu_references sets two
    kernels = {"dual_matvec": dm, "megakernel": mk, "cone_proj": cp,
               "psd_jacobi": pj}
    dpi = (("R+", ("rpos", 40)), ("SOC", ("soc", 5, 8)),
           ("RSOC", ("rsoc", 6, 4)), ("exp", ("expc", 200)),
           ("pow(1/2)", ("powc", 0.5, 200)),
           ("PSD (6, 2) jacobi", ("psd", 6, 2)))
    counts = cs.polish_diff_phases(
        tt, torch.device("cpu"), kernels, lambda: refs, lp_n=60, qp_n=10,
        grid=(3, 2), grid27=(2, 2), box_n=40, ell_n=256, dpi=dpi,
        prof_steps=5, diff_n=60)
    assert counts == {k: 0 for k in kernels}
    out = capsys.readouterr().out
    for phase in ("27a", "27b", "27c", "28a", "28b", "28c", "28d"):
        assert f"\nphase {phase} " in out



def test_make_fleet_is_the_benchmark_s():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "benchmarks"))
    import benchmark_admm
    c, a, b = cs.make_fleet(3, 5, 7, seed=2)
    cj, aj, bj, lay = benchmark_admm.make_fleet(3, 5, 7, seed=2)
    for got, want in ((c, cj), (a, aj), (b, bj)):
        np.testing.assert_array_equal(got, want)
    assert [(f.kind, f.dim) for f in lay.factors] == [("rpos", 7)]


def test_examples_torch_builders_are_the_examples():
    # the port's batch examples build what the JAX package's examples do
    import jax.numpy as jnp
    import mpc_qp
    import nearestcorr_batch_sdp
    import trajplan_qcqp
    from examples_torch import mpc_qp as tmpc
    from examples_torch import nearestcorr_batch_sdp as tnc
    from examples_torch import trajplan_qcqp as ttraj
    state, target = np.array([0.3, -1.0, 0.2, 0.1]), np.array([1.0, 2.0])
    for got, want in zip(tmpc.build_tick_qp(state, target, 5, 0.25, 1e-2,
                                            4.0),
                         mpc_qp.build_tick_qp(state, target, 5, 0.25, 1e-2,
                                              4.0)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnc.make_noisy_covs(3, 5),
                                  nearestcorr_batch_sdp.make_noisy_covs(3, 5))
    a, c, lay, pos, sn = tnc.build(5, torch.float64, "cpu")
    aj, cj, layj, posj, snj = nearestcorr_batch_sdp.build(5, jnp.float64)
    np.testing.assert_array_equal(a.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(pos, posj)
    assert _spec(lay) == _spec(layj) and sn == snj
    s = tnc.make_noisy_covs(1, 5)[0]
    np.testing.assert_allclose(
        tnc.lane_b(s, 5, sn, torch.float64, "cpu").numpy(),
        cs.nearestcorr_b(s), rtol=1e-15)
    for got, want in zip(ttraj.build(9, 120.0), trajplan_qcqp.build(9, 120.0)):
        np.testing.assert_array_equal(got, want)


def test_batch_helpers():
    import totsu_tpu_torch as tt
    assert cs.halpern_updates(60, 20) == 63
    res = tt.SolveResult(x=torch.zeros(3, 2), y=torch.zeros(3, 1),
                         status=torch.tensor([1, 2, 1]),
                         iters=torch.tensor([40, 100, 60]),
                         cri_pri=None, cri_dual=None, cri_gap=None,
                         cri_unbdd=None, cri_infeas=None)
    assert cs.lanes_summary(res) == ("CONVERGED x2 EXCESS_ITER x1", "60/100")
    assert cs.same_batch(res, res)
    other = tt.SolveResult(**{**res.__dict__, "x": torch.ones(3, 2)})
    assert not cs.same_batch(res, other)


def test_batch_phases_run_on_the_cpu_at_a_small_size(monkeypatch, capsys):
    # phases 29-33's flow (every solve, gate and line) at small sizes on
    # the CPU, with the card's timers stubbed and kernels B and J counted
    # where their plain versions stand in for them
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj

    real_cp, real_pj = cp.cone_proj, pj.proj_psd_jacobi

    def cp_launch(*args, **kw):
        cp.launches += 1
        return real_cp(*args, **kw)

    def pj_launch(*args, **kw):
        pj.launches += 1
        return real_pj(*args, **kw)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(cs, "profile_loop",
                        lambda fn, iters: (fn(), (1.0, 0.5, 9.0, []))[1])
    monkeypatch.setattr(cp, "cone_proj", cp_launch)
    monkeypatch.setattr(pj, "proj_psd_jacobi", pj_launch)
    kernels = {"dual_matvec": dm, "megakernel": mk, "cone_proj": cp,
               "psd_jacobi": pj}
    counts = cs.batch_phases(
        tt, torch.device("cpu"), kernels, n29=8, lanes29=4, lanes29b=3,
        iters29b=40, lanes29c=4, growth=(4, 12), cov31=(6, 3), singles31=2,
        mpc=dict(n_vehicles=3, h_horizon=4, ticks=8), burst=8,
        fleet=(2, 4, 16), admm_outer=40,
        sweep=dict(t_cap=10, caps=(200.0, 300.0)))
    assert counts["cone_proj"] > 0 and counts["psd_jacobi"] > 0
    assert counts["dual_matvec"] == counts["megakernel"] == 0
    out = capsys.readouterr().out
    for phase in ("29a", "29b", "29c", "30", "31", "32", "33"):
        assert f"\nphase {phase} " in out


def test_distribution_phases_run_on_the_cpu_at_a_small_size(capsys):
    # phases 34-35's flow (every spawned world, solve, gate and line) at
    # small sizes on the CPU: the ranks join through gloo on CPU tensors,
    # and kernel B's plain version stands in for it against the engine
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj
    kernels = {"dual_matvec": dm, "megakernel": mk, "cone_proj": cp,
               "psd_jacobi": pj}
    cpu = torch.device("cpu")
    counts = cs.distribution_phases(
        tt, cpu, kernels, lp_n=20, dense_iters=100, f32_iters=60,
        ell_n=256, ell_iters=40, n34c=8, lanes34c=4, iters34c=40,
        fleet=(2, 4, 16), admm_rounds=2, coll_reps=5, timeout=120)
    assert counts == {k: 0 for k in kernels}
    cs.native_phase(tt, cpu, kernels)
    out = capsys.readouterr().out
    for phase in ("34a", "34b", "34c", "34d", "34e", "35"):
        assert f"phase {phase} " in out
    assert "is_multihost [True, True]" in out


def test_tiles_box_ell_is_the_tiles_lp_stacked():
    import totsu_tpu_torch as tt
    op, b, c = cs.tiles_box_ell(tt, 256, torch.device("cpu"))
    tiles, b0, c0 = cs.make_tiles_lp(256)
    np.testing.assert_array_equal(b, b0)
    np.testing.assert_array_equal(c, c0)
    want = cs.tiles_box_csr(tiles, 256, 128).toarray()
    np.testing.assert_array_equal(op.to_dense().numpy(), want)


def test_batch_launches_are_counted_apart(monkeypatch):
    # the kernels line's megakernel row counts single solves' launches and
    # its megakernel_batch row the batched ones: the script reads and
    # resets the batch's count under the name every count goes by
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    monkeypatch.setattr(mk, "launches", 3)
    monkeypatch.setattr(mk, "batch_launches", 5)
    counter = cs.BatchLaunches(mk)
    assert counter.launches == 5
    counter.launches = 0
    assert mk.batch_launches == 0 and mk.launches == 3


def test_batch_mega_and_examples_phases_run_on_the_cpu(monkeypatch, capsys):
    # phases 36-37's flow (every solve, gate and line) at small sizes on
    # the CPU, where the batched megakernel runs its plain version: phase
    # 29's batches kept from a small batch_phases run, then 36 on them and
    # 37 on two examples (f64 on the CPU)
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    kernels = {"dual_matvec": dm, "megakernel": mk, "cone_proj": cp,
               "psd_jacobi": pj, "megakernel_batch": cs.BatchLaunches(mk)}
    cpu = torch.device("cpu")
    f32 = torch.float32
    rng = np.random.default_rng(1)
    lp = [cs.make_lp(6, seed=100 + i) for i in range(3)]
    c64, a64, b64 = (torch.tensor(np.stack([x[j] for x in lp]), dtype=f32)
                     for j in range(3))
    lay = tt.ConeLayout([tt.rpos(24)])
    p64 = tt.SolverParam(max_iter=40, eps_acc=1e-9, check_period=20)
    r64 = tt.solve_batch(c64, a64, b64, lay, p64)
    c1, g1, h1 = (torch.tensor(x) for x in cs.make_lp(6))
    c29 = torch.stack([c1 * (1.0 + 0.1 * float(rng.random()))
                       for _ in range(2)])
    p29 = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, check_period=20,
                         accel="halpern")
    a29, b29 = g1.expand(2, -1, -1), h1.expand(2, -1)
    r29 = tt.solve_batch(c29, a29, b29, lay, p29)
    grs = [cs.make_growth(4, 6, -1.2, seed=i) for i in range(2)]
    gcone = cs.cone(tt, grs[0][4])
    cg, ag, bg = (torch.tensor(np.stack([g[j] for g in grs]), dtype=f32)
                  for j in (1, 2, 3))
    pg = tt.SolverParam(accel="halpern", normalize=True, equil_iters=10,
                        check_period=20, eps_acc=1e-4, max_iter=200_000)
    rg = tt.solve_batch(cg, ag, bg, gcone, pg)
    kept = {"29a": (c29, a29, b29, lay, p29, r29, 1.0),
            "29b": (c64, a64, b64, lay, p64, r64, 1e5),
            "29c": (cg, ag, bg, gcone, pg, rg)}
    counts, row = cs.batch_mega_phases(tt, cpu, kernels, kept, lanes36d=4,
                                       n36d=6, iters36d=40, burst36=2,
                                       record_iters=20, sample=(0, 2))
    assert counts == {k: 0 for k in kernels}
    assert row["name"] == "megakernel_batch" and row["library_ms"] is None
    assert set(row) >= {"route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "plan"}
    assert cs.examples_phase(cpu, kernels, examples=(
        ("partitioning_sdp", dict(x_num=4, y_num=3)),
        ("leastsq_qp", dict(mrows=30, n=8)))) == {k: 0 for k in kernels}
    out = capsys.readouterr().out
    for phase in ("36a", "36b", "36c", "36d", "36e", "37"):
        assert f"\nphase {phase} " in out


def test_structured_batch_phases_run_on_the_cpu_at_a_small_size(monkeypatch,
                                                                capsys):
    # phase 38's flow (every solve, gate and line) at n = 256 and k = 4 on
    # the CPU, the card's timers stubbed and kernel J's launch standing in
    # for its plain version (counted as a launch); HiGHS runs in its
    # children as on the card
    import totsu_tpu_torch as tt
    from totsu_tpu_torch.ops.kernels import dual_matvec as dm
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    from totsu_tpu_torch.ops.kernels import psd_jacobi as pj

    def timed(fn, *args, **kw):
        fn()
        return 1e-3

    def launch(v, scaled=True, sweeps=None):
        pj.launches += 1
        return pj.proj_psd_jacobi_plain(v, scaled, sweeps)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(cs, "stream_ms", timed)
    monkeypatch.setattr(cs, "profile_loop",
                        lambda fn, iters: (fn(), (1.0, 0.5, 9.0, []))[1])
    monkeypatch.setattr(pj, "proj_psd_jacobi",
                        lambda v, scaled=True, sweeps=None: launch(
                            v.reshape(-1, v.shape[-1]), scaled,
                            sweeps).reshape(v.shape))
    kernels = {"dual_matvec": dm, "megakernel": mk, "cone_proj": cp,
               "psd_jacobi": pj}
    counts = cs.structured_batch_phases(
        tt, torch.device("cpu"), kernels, n38=256, k38=4, iters38b=200,
        prof38=20, iters38d=50, n38e=256)
    assert counts["psd_jacobi"] > 0
    assert {k: v for k, v in counts.items() if k != "psd_jacobi"} == {
        k: 0 for k in kernels if k != "psd_jacobi"}
    out = capsys.readouterr().out
    for phase in ("38a", "38b", "38c", "38d"):
        assert f"\nphase {phase} " in out
    assert "chunks of 100 bitwise the whole" in out
