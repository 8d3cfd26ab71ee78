"""BatchRunner of the PyTorch port: twins of ``tests/test_runtime.py``.

Each twin runs the JAX test's scenario on the port (``device="cpu"``,
f64) and, where the scenario solves, holds every request's status and
iteration count to the JAX package's ``BatchRunner`` on the same problems
and x within 1e-8. Padding lanes and ``None`` warm starts take zero
seeds in both packages.
"""

import numpy as np
import pytest
import torch

import totsu_tpu as jt
from totsu_tpu.runtime import BatchRunner as JBatchRunner
import totsu_tpu_torch as tt
from totsu_tpu_torch.runtime import BatchRunner
from totsu_tpu_torch.runtime.batcher import _tier_chunks
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

CPU = "cpu"


def box_lp(c, pkg=tt):
    n = len(c)
    eye = np.eye(n)
    g = np.concatenate([eye, -eye])
    h = np.ones(2 * n)
    return (np.asarray(c, dtype=float), g, h,
            pkg.ConeLayout([pkg.rpos(2 * n)]))


def assert_same(port, ref):
    """Per-request parity with the JAX package's runner."""
    assert len(port) == len(ref)
    for rp, rj in zip(port, ref):
        assert rp.status == int(rj.status)
        assert rp.iters == int(rj.iters)
        np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x),
                                   atol=1e-8, rtol=0)


def test_batch_runner_mixed_shapes():
    runner = BatchRunner(tt.SolverParam(max_iter=50_000), device=CPU)
    jrunner = JBatchRunner(jt.SolverParam(max_iter=50_000))
    problems, jproblems, expected = [], [], []
    rng = np.random.default_rng(0)
    for i in range(7):
        n = 3 if i % 2 == 0 else 5
        c = rng.normal(size=n) + np.where(rng.random(n) > 0.5, 0.6, -0.6)
        problems.append(box_lp(c))
        jproblems.append(box_lp(c, jt))
        expected.append(-np.sign(c))
    results = runner.map(problems)
    assert len(results) == 7
    for res, exp in zip(results, expected):
        assert res.status == tt.SolverStatus.CONVERGED
        np.testing.assert_allclose(res.x.numpy(), exp, atol=1e-3)
    assert runner.compiled_signatures >= 2
    assert_same(results, jrunner.map(jproblems))


def test_batch_runner_warm_starts():
    runner = BatchRunner(tt.SolverParam(max_iter=50_000, check_period=10),
                         device=CPU)
    jrunner = JBatchRunner(jt.SolverParam(max_iter=50_000, check_period=10))
    rng = np.random.default_rng(4)
    cs = [rng.normal(size=4) * 2.0 for _ in range(3)]
    problems = [box_lp(c) for c in cs]
    cold = runner.map(problems)
    assert all(r.status == tt.SolverStatus.CONVERGED for r in cold)
    seeds = [(r.x.numpy(), r.y.numpy()) for r in cold]
    seeds[1] = None                     # mixed warm/cold batch
    warm = runner.map(problems, warm_starts=seeds)
    for i, (rc, rw) in enumerate(zip(cold, warm)):
        assert rw.status == tt.SolverStatus.CONVERGED
        np.testing.assert_allclose(rw.x.numpy(), rc.x.numpy(), atol=1e-3)
        if i != 1:  # re-solving from the optimum terminates immediately
            assert rw.iters <= rc.iters
    assert warm[0].iters == 0
    assert_same(warm, jrunner.map([box_lp(c, jt) for c in cs],
                                  warm_starts=seeds))
    with pytest.raises(ValueError):
        runner.map(problems, warm_starts=seeds[:1])


def test_batch_runner_reuses_executables():
    runner = BatchRunner(tt.SolverParam(max_iter=50_000), device=CPU)
    p1 = [box_lp([1.0, -2.0, 0.5]) for _ in range(4)]
    runner.map(p1)
    n_compiled = runner.compiled_signatures
    # same signature + same tier -> no new prepared solver
    runner.map(p1)
    assert runner.compiled_signatures == n_compiled


def test_batch_runner_accepts_conic_problems():
    runner = BatchRunner(tt.SolverParam(max_iter=50_000))
    prob = tt.problems.lp([1.0, 1.0], g=[[-1.0, 0.0], [0.0, -1.0]],
                          h=[-1.0, -2.0], device=CPU)
    (res,) = runner.map([prob])
    np.testing.assert_allclose(res.x.numpy(), [1.0, 2.0], atol=1e-3)
    assert res.x.device.type == "cpu"   # the problem's own device


def test_tier_decomposition_bounded_padding():
    from totsu_tpu.runtime.batcher import _tier_chunks as jtier
    tiers = (1, 2, 4, 8, 16, 32, 64, 128, 256)
    for count in (1, 2, 3, 7, 19, 255, 256, 300, 777):
        chunks = _tier_chunks(count)
        assert chunks == jtier(count)
        assert sum(used for _, used in chunks) == count
        assert all(t in tiers and 0 < used <= t for t, used in chunks)
        tail = [(t, u) for t, u in chunks if t != 256 or u != 256]
        assert len(tail) <= 2
        assert all(t == u for t, u in chunks[:-1])
    assert _tier_chunks(19) == [(16, 16), (4, 3)]
    assert _tier_chunks(255) == [(128, 128), (128, 127)]


def test_batch_runner_lru_eviction():
    runner = BatchRunner(tt.SolverParam(max_iter=20_000), max_cached=2,
                         device=CPU)
    for n in (2, 3, 4):
        runner.map([box_lp([1.0] * n)])
    assert runner.compiled_signatures == 2  # capped, oldest evicted


def test_batch_runner_async_submit():
    runner = BatchRunner(tt.SolverParam(max_iter=50_000), device=CPU)
    rng = np.random.default_rng(3)
    futs, expected, problems = [], [], []
    for _ in range(9):
        c = rng.normal(size=3) + np.where(rng.random(3) > 0.5, 0.6, -0.6)
        problems.append(box_lp(c))
        futs.append(runner.submit(problems[-1], flush_ms=20.0))
        expected.append(-np.sign(c))
    for fut, exp in zip(futs, expected):
        res = fut.result(timeout=120)
        assert res.status == tt.SolverStatus.CONVERGED
        np.testing.assert_allclose(res.x.numpy(), exp, atol=1e-3)
    # a future's result is its request's solve, whatever batch it rode in
    for fut, ref in zip(futs, runner.map(problems)):
        assert torch.equal(fut.result().x, ref.x)


def test_batch_runner_cancelled_future_does_not_poison_batch():
    runner = BatchRunner(tt.SolverParam(max_iter=50_000), device=CPU)
    futs = [runner.submit(box_lp([1.0, -1.0, 0.5]), flush_ms=300.0)
            for _ in range(3)]
    cancelled = futs[0].cancel()  # False if the collector already claimed it
    for f in futs[1:]:
        res = f.result(timeout=120)
        assert res.status == tt.SolverStatus.CONVERGED
        np.testing.assert_allclose(res.x.numpy(), [-1.0, 1.0, -1.0],
                                   atol=1e-3)
    if cancelled:
        assert futs[0].cancelled()


def test_runner_data_goes_to_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchRunner().map([box_lp([1.0, 2.0])])
