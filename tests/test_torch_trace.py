"""The port's profiler ranges (``totsu_tpu_torch.utils.trace``) on the CPU.

Recorded with ``torch.profiler``, a direct-engine solve shows one
``totsu.solve`` around one ``totsu.direct.cache`` and one pair of
``totsu.loop.iterate`` / ``totsu.loop.check`` per check period, the
iterate ranges holding exactly the iterations ``SolveResult.iters``
counts. Without a profiler the ranges are one shared no-op and the solve
is bitwise the traced one.
"""

import numpy as np
import pytest
import torch

import totsu_tpu_torch as tt
from totsu_tpu_torch.utils import trace

CPU = [torch.profiler.ProfilerActivity.CPU]


def _lp(n=10, seed=3):
    """A small dense f32 LP: random inequalities and the box |x| <= 10."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    a = np.concatenate([g, np.eye(n), -np.eye(n)])
    b = np.concatenate([h, np.full(2 * n, 10.0)])
    c = rng.normal(size=n)
    return ([torch.tensor(x, dtype=torch.float32) for x in (c, a, b)]
            + [tt.ConeLayout([tt.rpos(4 * n)])])


def _param(check_period=20, **kw):
    fields = dict(method="direct", accel="halpern", max_iter=100_000,
                  eps_acc=1e-3)
    return tt.SolverParam(check_period=check_period, **{**fields, **kw})


def _recorded(fn):
    """``fn()``'s result and its ``totsu.*`` ranges, (name, start, end)
    in order of start."""
    with torch.profiler.profile(activities=CPU) as prof:
        out = fn()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("totsu."))
    return out, [(n, s, e) for s, e, n in spans]


def _count(spans, name):
    return sum(1 for n, _, _ in spans if n == name)


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("check_period", [20, 7])
def test_direct_solve_ranges(check_period):
    prob = _lp()
    res, spans = _recorded(lambda: tt.solve_jit(*prob, _param(check_period)))
    assert res.status == tt.SolverStatus.CONVERGED
    assert _count(spans, "totsu.solve") == 1
    assert _count(spans, "totsu.direct.cache") == 1
    loops = _count(spans, "totsu.loop.iterate")
    assert loops == _count(spans, "totsu.loop.check") > 1
    assert loops * check_period == res.iters
    solve = next(s for s in spans if s[0] == "totsu.solve")
    assert all(_inside(s, solve) for s in spans)
    # the cache is built before the loop; each check follows its iterate
    cache = next(s for s in spans if s[0] == "totsu.direct.cache")
    body = [s for s in spans if s[0].startswith("totsu.loop.")]
    assert cache[2] <= body[0][1]
    assert [s[0] for s in body] == ["totsu.loop.iterate",
                                    "totsu.loop.check"] * loops
    assert all(a[2] <= b[1] for a, b in zip(body, body[1:]))


def test_resumed_solve_builds_no_cache_range():
    prob = _lp()
    part = tt.solve_jit(*prob, _param(max_iter=40, return_state=True))
    assert part.iters == 40 and "prec" in part.state.aux
    res, spans = _recorded(lambda: tt.solve_jit(
        *prob, _param(), resume_state=part.state))
    assert res.status == tt.SolverStatus.CONVERGED
    assert _count(spans, "totsu.solve") == 1
    assert _count(spans, "totsu.direct.cache") == 0
    assert _count(spans, "totsu.loop.iterate") * 20 == res.iters


def test_chunked_solve_opens_a_range_per_chunk():
    prob = _lp()
    res, spans = _recorded(lambda: tt.solve(*prob, _param(),
                                            chunk_iters=40))
    assert res.converged
    assert _count(spans, "totsu.solve") == -(-res.iters // 40) > 1
    assert _count(spans, "totsu.direct.cache") == 1
    assert _count(spans, "totsu.loop.iterate") * 20 == res.iters


def test_ranges_off_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = trace.span("totsu.solve")
    assert off is trace.span("totsu.loop.check")
    with off:
        pass
    prob = _lp()
    plain = tt.solve_jit(*prob, _param())
    traced, spans = _recorded(lambda: tt.solve_jit(*prob, _param()))
    assert spans
    assert plain.iters == traced.iters
    assert torch.equal(plain.x, traced.x) and torch.equal(plain.y, traced.y)


def test_span_records_under_a_profiler():
    with torch.profiler.profile(activities=CPU):
        assert trace.span("totsu.x") is not trace.span("totsu.y")
