"""The program's ranges in a traced run (``program_spans``), on synthetic
kineto-like events: a kernel goes to the innermost ``totsu.*`` range open
when it was launched, an idle gap to the range open at its middle, the
readers of these keys read nothing without a trace or without ranges,
and ``trace.summarize`` keeps every key it had."""

import dataclasses
import time

import pytest
import torch

from h100bench import harness, program_spans, trace

from conftest import REPO

SEED = 2**31 + 4242
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
READERS = ["cache_build_s", "iterate_roofline", "iterate_launches_per_iter",
           "check_pct", "loop_idle_pct"]


@dataclasses.dataclass
class Ev:
    """The part of a kineto event the summaries read."""
    name_: str
    start: int
    dur: int
    kind: str
    corr: int = 0
    on_device: bool = False

    def name(self):
        return self.name_

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def device_type(self):
        return CUDA if self.on_device else CPU

    def is_user_annotation(self):
        return self.kind in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self.corr


def _span(name, start, end):
    return Ev(name, start, end - start, "user_annotation")


def _launch(corr, at, kernel, start, end):
    """A launch call on the host at ``at`` and its kernel on the device."""
    return [Ev("cudaLaunchKernel", at, 5, "cuda_runtime", corr),
            Ev(kernel, start, end - start, "kernel", corr, True)]


def _events():
    """One solve [100, 2000]: the cache [150, 400], one iterate [500, 900]
    and its check [900, 1200]; a kernel launched in each, one in the
    solve's own time, one outside, one with no launch event, and a
    Memcpy. Kernels launched in the iterate run while the host is in the
    check."""
    ev = [_span("totsu.solve", 100, 2000),
          _span("totsu.direct.cache", 150, 400),
          _span("totsu.loop.iterate", 500, 900),
          _span("totsu.loop.check", 900, 1200),
          _span("h100bench.solve", 90, 2010),
          Ev("aten::mm", 160, 20, "cpu_op", 1),      # an op's own id space
          Ev("totsu.loop.iterate", 500, 400, "gpu_user_annotation", 0,
             True)]
    ev += _launch(1, 160, "sgemm", 200, 300)            # cache
    ev += _launch(2, 510, "gemv", 600, 950)             # iterate
    ev += _launch(3, 520, "gemv", 950, 1000)            # iterate
    ev += _launch(4, 910, "dual_matvec", 1050, 1100)    # check
    ev += _launch(5, 1300, "add", 1400, 1450)           # solve's own
    ev += _launch(6, 2100, "fill", 2200, 2250)          # outside
    ev.append(Ev("lost", 2300, 10, "kernel", 99, True))  # no launch event
    ev += [Ev("cudaMemcpyAsync", 1150, 5, "cuda_runtime", 7),
           Ev("Memcpy DtoH", 1120, 20, "gpu_memcpy", 7, True)]
    return ev


def test_kernels_go_to_the_range_open_at_their_launch():
    out = program_spans.summarize(_events())
    assert out["span_kernels"] == {
        "totsu.direct.cache": (pytest.approx(100e-9), 1),
        "totsu.loop.iterate": (pytest.approx(400e-9), 2),
        "totsu.loop.check": (pytest.approx(50e-9), 1),
        "totsu.solve": (pytest.approx(50e-9), 1),
        "outside": (pytest.approx(50e-9), 1),
        "unlinked": (pytest.approx(10e-9), 1)}
    assert [s[0] for s in out["spans"]] == [
        "totsu.solve", "totsu.direct.cache", "totsu.loop.iterate",
        "totsu.loop.check"]
    # every kernel that trace.launches counts is put down somewhere
    base = trace.summarize(_events(), 1.0)
    assert sum(v[1] for v in out["span_kernels"].values()) == sum(
        v[1] for k, v in base["kernels"].items()
        if not k.startswith(("Memcpy", "Memset")))


def test_gaps_go_to_the_range_open_at_their_middle():
    out = program_spans.summarize(_events())
    # busy: [200, 300] [600, 1000] [1050, 1100] [1120, 1140] [1400, 1450]
    # [2200, 2250] [2300, 2310]; the first gap opens at the first host
    # event (90). Middles: 145, 450, 1270, 1825 in the solve's own time,
    # 1025 and 1110 in the check, 2275 outside
    assert out["span_idle"] == {
        "totsu.solve": pytest.approx((110 + 300 + 260 + 750) * 1e-9),
        "totsu.loop.check": pytest.approx((50 + 20) * 1e-9),
        "outside": pytest.approx(50e-9)}
    base = trace.summarize(_events(), 1.0)
    assert sum(out["span_idle"].values()) == pytest.approx(
        sum(v for _, v in base["idle_gaps"]))


@pytest.mark.parametrize("t, want", [
    (95, "outside"), (120, "totsu.solve"), (200, "totsu.direct.cache"),
    (450, "totsu.solve"), (700, "totsu.loop.iterate"),
    (899, "totsu.loop.iterate"), (900, "totsu.loop.check"),
    (1500, "totsu.solve"), (2100, "outside")])
def test_innermost_range(t, want):
    spans = program_spans._read(_events())[1]
    i = program_spans._innermost(spans, [t])[0]
    assert program_spans._name(spans, i) == want


def test_loop_stretch():
    out = program_spans.summarize(_events())
    # the loop's kernels run from 600 to 1100; busy there 600-1000,
    # 1050-1100
    idle, stretch = out["loop_stretch"]
    assert stretch == pytest.approx(500e-9)
    assert idle == pytest.approx(50e-9)


def test_a_trace_without_ranges():
    ev = [e for e in _events() if not e.name().startswith("totsu.")]
    out = program_spans.summarize(ev)
    assert out["spans"] == [] and out["loop_stretch"] is None
    assert set(out["span_kernels"]) == {"outside", "unlinked"}
    assert set(out["span_idle"]) == {"outside"}
    assert program_spans.summarize([]) == {
        "spans": [], "span_kernels": {}, "span_idle": {},
        "loop_stretch": None}


def test_summarize_keeps_its_keys(monkeypatch, capsys):
    plain = getattr(trace.summarize, "plain", trace.summarize)
    monkeypatch.setattr(trace, "summarize", plain)
    before = plain(_events(), 1.0)
    program_spans.install()
    program_spans.install()
    assert trace.summarize.plain is plain
    after = trace.summarize(_events(), 1.0)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {"spans", "span_kernels",
                                        "span_idle", "loop_stretch"}
    err = capsys.readouterr().err
    assert err.count("h100bench: idle_s by span:") == 1
    assert "totsu.loop.iterate" in err


def test_a_failed_summary_leaves_the_run_its_line(monkeypatch, capsys):
    plain = getattr(trace.summarize, "plain", trace.summarize)
    monkeypatch.setattr(trace, "summarize", plain)
    program_spans.install()

    def broken(events):
        raise AttributeError("no such method")
    monkeypatch.setattr(program_spans, "summarize", broken)
    out = trace.summarize(_events(), 1.0)
    assert out == plain(_events(), 1.0)
    assert "AttributeError" in capsys.readouterr().err


class _Family:
    @staticmethod
    def dims(config):
        return config["m"], config["n"]


def _fake_run(summary, iters):
    run = type("Run", (), {})()
    run.tracer = type("Tracer", (), {"summary": summary})()
    run.traced_iters = iters
    run.family, run.config = _Family, {"m": 40, "n": 10}
    return run


def _reader(name):
    return harness.load_reader(REPO / "h100bench", f"{name}.large")


def test_readers_on_a_trace():
    s = trace.summarize(_events(), 1.0)
    s.update(program_spans.summarize(_events()))
    run = _fake_run(s, [20])
    got = {n: _reader(n)(run) for n in READERS}
    need = (2 * 40 * 10 + 10 * 10) * 4.0 * 20
    assert got["cache_build_s"] == pytest.approx(100e-9)
    assert got["iterate_roofline"] == pytest.approx(
        need / 3.35e12 / 400e-9 * 100)
    assert got["iterate_launches_per_iter"] == pytest.approx(2 / 20)
    assert got["check_pct"] == pytest.approx(50 / 450 * 100)
    assert got["loop_idle_pct"] == pytest.approx(10.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_ranges(name):
    """No trace (an untraced run, a CPU run), or a trace of a program that
    opens no range: nothing is read, nothing raises."""
    ev = [e for e in _events() if not e.name().startswith("totsu.")]
    s = trace.summarize(ev, 1.0)
    s.update(program_spans.summarize(ev))
    assert _reader(name)(_fake_run(None, [20])) is None
    assert _reader(name)(_fake_run(s, [20])) is None
    assert _reader(name)(_fake_run(s, [])) is None


def test_cpu_profiler_events_give_the_ranges():
    """The port's ranges as the profiler records them: host events of
    kind ``user_annotation``."""
    import numpy as np
    import totsu_tpu_torch as tt
    rng = np.random.default_rng(0)
    g = rng.normal(size=(16, 8))
    a = np.concatenate([g, np.eye(8), -np.eye(8)])
    b = np.concatenate([g @ rng.normal(size=8) + 0.5, np.full(16, 10.0)])
    prob = [torch.tensor(x, dtype=torch.float32)
            for x in (rng.normal(size=8), a, b)]
    param = tt.SolverParam(method="direct", accel="halpern",
                           check_period=20, max_iter=20_000)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = tt.solve_jit(*prob, tt.ConeLayout([tt.rpos(32)]), param)
    out = program_spans.summarize(prof.profiler.kineto_results.events())
    names = [s[0] for s in out["spans"]]
    assert names[:2] == ["totsu.solve", "totsu.direct.cache"]
    assert names.count("totsu.loop.iterate") * 20 == res.iters
    assert out["span_kernels"] == {} and out["loop_stretch"] is None


def test_traced_cpu_run_reports_none_of_them(tiny_root):
    line, _ = harness.run_cell(tiny_root, "lp8r.single", SEED, 1.5, True,
                               time.perf_counter(), require_cuda=False,
                               keep_run=True, program_root=REPO)
    assert line["correct"]
    assert not {f"{n}.large" for n in READERS} & set(line["metrics"])
    assert "breakdown" not in line
