"""Lockstep batched solves of the PyTorch port against the JAX package.

``totsu_tpu_torch.solve_batch`` writes out what the JAX package's
``solve_batch`` gets from ``jax.vmap(solve_jit)``: lanes iterate in
lockstep and a lane that has stopped keeps its carry. Each batch is made
once with numpy and handed to both packages; in f64 on the CPU every
lane's status and iteration count must equal the JAX package's and x
agree within 1e-8, across the accelerations, relax, normalize with Ruiz,
warm starts, the direct engine, exp lanes and PSD lanes on 'jacobi' and
'eigh'. In f32 the statuses must agree. Each lane must also equal its
own single ``solve_jit`` of the port.

The JAX package's ``solve_batch`` skips the host policy of ``solve``
(auto-equilibration, the CG warning, polish); the port mirrors that
(ROADMAP §3), which ``test_batch_skips_the_host_policy`` pins.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
from totsu_tpu.parallel import solve_batch as jsolve_batch
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.parallel import solve_batch
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))

#: x of a lane against the JAX package's, f64
XTOL = 1e-8


def lp_batch(lanes=4, n=6, seed=0):
    """bench.make_lp's shape at a small n, one instance per lane: random
    inequalities plus the box |x| <= 10, A (4n, n), R+."""
    rng = np.random.default_rng(seed)
    cs, as_, bs = [], [], []
    for _ in range(lanes):
        g = rng.normal(size=(2 * n, n))
        h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
        eye = np.eye(n)
        as_.append(np.concatenate([g, eye, -eye]))
        bs.append(np.concatenate([h, np.full(2 * n, 10.0)]))
        cs.append(rng.normal(size=n))
    return np.stack(cs), np.stack(as_), np.stack(bs), 4 * n


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def run_both(c, a, b, jlay, pkw, dtype=np.float64, warm=None, **kw):
    """(JAX result, port result) of one batch."""
    pj = jt.SolverParam(**pkw)
    jw = None if warm is None else tuple(
        None if w is None else jnp.asarray(w, dtype) for w in warm)
    rj = jsolve_batch(jnp.asarray(c, dtype), jnp.asarray(a, dtype),
                      jnp.asarray(b, dtype), jlay, pj, warm_start=jw, **kw)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tw = None if warm is None else tuple(
        None if w is None else _t(w, tdt) for w in warm)
    rt = solve_batch(_t(c, tdt), _t(a, tdt), _t(b, tdt),
                     interop.cone_from_reference(jlay),
                     interop.param_from_reference(pj), warm_start=tw, **kw)
    return rj, rt


def assert_lanes_match(rj, rt, xtol=XTOL):
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=xtol,
                               rtol=0)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), atol=xtol,
                               rtol=0)


LP_CASES = {
    "plain": dict(eps_acc=1e-5, check_period=10),
    "halpern": dict(eps_acc=1e-7, check_period=10, accel="halpern"),
    "restart": dict(eps_acc=1e-7, check_period=10, accel="restart"),
    "relax": dict(eps_acc=1e-5, check_period=10, relax=1.5),
    "normalize_ruiz": dict(eps_acc=1e-6, check_period=10, accel="halpern",
                           normalize=True, equil_iters=5),
    "direct": dict(eps_acc=1e-7, check_period=10, method="direct"),
    "direct_halpern": dict(eps_acc=1e-8, check_period=10, method="direct",
                           accel="halpern"),
    "fast_profile": dict(eps_acc=1e-7, profile="fast"),
    "matvec_f32": dict(eps_acc=1e-5, check_period=10, accel="halpern",
                       matvec_dtype="float32"),
}


@pytest.mark.parametrize("name", list(LP_CASES))
def test_lp_lanes_match_the_jax_package(name):
    c, a, b, m = lp_batch()
    rj, rt = run_both(c, a, b, jt.ConeLayout([jt.rpos(m)]),
                      dict(max_iter=30_000, **LP_CASES[name]))
    assert_lanes_match(rj, rt)
    assert (rt.status == tt.SolverStatus.CONVERGED).all()
    # the lanes stop at different checks: the lockstep keeps each one's
    # own count
    assert len(set(rt.iters.tolist())) > 1


@pytest.mark.parametrize("accel", ["", "halpern", "restart"])
def test_each_lane_is_its_own_solve(accel):
    c, a, b, m = lp_batch(lanes=3, seed=1)
    lay = tt.ConeLayout([tt.rpos(m)])
    p = tt.SolverParam(max_iter=30_000, eps_acc=1e-5, check_period=10,
                       accel=accel)
    res = solve_batch(_t(c), _t(a), _t(b), lay, p)
    for i in range(3):
        one = tt.solve_jit(_t(c[i]), _t(a[i]), _t(b[i]), lay, p)
        assert one.status == int(res.status[i])
        assert one.iters == int(res.iters[i])
        np.testing.assert_allclose(res.x[i].numpy(), one.x.numpy(),
                                   atol=1e-12, rtol=0)
        np.testing.assert_allclose(float(res.cri_pri[i]),
                                   float(one.cri_pri), rtol=1e-6)


@pytest.mark.parametrize("method", ["pdhg", "direct"])
@pytest.mark.parametrize("parts", ["x_and_y", "x_only"])
def test_warm_starts_match_the_jax_package(method, parts):
    c, a, b, m = lp_batch(seed=2)
    kw = dict(max_iter=30_000, eps_acc=1e-7, check_period=10,
              accel="halpern", method=method)
    _, cold = run_both(c, a, b, jt.ConeLayout([jt.rpos(m)]), kw)
    x0 = cold.x.numpy() + 0.01
    y0 = cold.y.numpy() if parts == "x_and_y" else None
    # a zero seed in a lane: the seeded start (slack at Pi_K(b), a check
    # at the seed), as in the JAX package
    x0[1] = 0.0
    if y0 is not None:
        y0 = y0.copy()
        y0[1] = 0.0
    rj, rt = run_both(c, a, b, jt.ConeLayout([jt.rpos(m)]), kw,
                      warm=(x0, y0))
    assert_lanes_match(rj, rt)


def test_warm_start_at_the_solution_stops_at_zero_iterations():
    c, a, b, m = lp_batch(lanes=2, seed=3)
    lay = tt.ConeLayout([tt.rpos(m)])
    p = tt.SolverParam(max_iter=30_000, eps_acc=1e-6, check_period=10,
                       accel="halpern")
    cold = solve_batch(_t(c), _t(a), _t(b), lay, p)
    warm = solve_batch(_t(c), _t(a), _t(b), lay, p,
                       warm_start=(cold.x, cold.y))
    assert warm.iters.tolist() == [0, 0]
    assert (warm.status == 1).all()


def test_logging_prints_each_lane_s_lines(capsys):
    c, a, b, m = lp_batch(lanes=2, seed=6)
    lay = tt.ConeLayout([tt.rpos(m)])
    p = tt.SolverParam(max_iter=30_000, eps_acc=1e-6, check_period=10,
                       accel="halpern", log_period=50)
    solve_batch(_t(c), _t(a), _t(b), lay, p)
    batch_lines = sorted(capsys.readouterr().out.splitlines())
    singles = []
    for i in range(2):
        tt.solve_jit(_t(c[i]), _t(a[i]), _t(b[i]), lay, p)
        singles += capsys.readouterr().out.splitlines()
    assert batch_lines and batch_lines == sorted(singles)


def test_batch_skips_the_host_policy():
    """Mirrors the JAX package: solve_batch never raises on a status,
    and runs no polish (its host policy lives in solve())."""
    c, a, b, m = lp_batch(lanes=2, seed=7)
    res = solve_batch(_t(c), _t(a), _t(b), tt.ConeLayout([tt.rpos(m)]),
                      tt.SolverParam(max_iter=20, eps_acc=1e-9))
    assert (res.status == int(tt.SolverStatus.EXCESS_ITER)).all()
    assert res.x.dtype == torch.float64 and res.state is None


def test_unported_options_raise_naming_their_item():
    """A structured operator without a lane axis is no batch (ValueError
    naming BatchedOp.stack, as JAX's vmap refuses it); kernel='mega' in a
    batch solves (the batched megakernel, its plain version here) and
    refuses a row-sharded batch as the single solve refuses a
    row_sharding; every name of the distribution layer works, here on a
    1-rank gloo mesh, and a mesh that is not a DeviceMesh is a
    TypeError."""
    import torch.distributed as dist
    from totsu_tpu_torch import parallel
    c, a, b, m = lp_batch(lanes=2)
    lay = tt.ConeLayout([tt.rpos(m)])
    args = (_t(c), _t(a), _t(b), lay)
    p = tt.SolverParam(max_iter=200)
    f32 = tuple(x.float() for x in args[:3]) + (lay,)
    mega = solve_batch(*f32, tt.SolverParam(kernel="mega", max_iter=200))
    assert mega.diag["route"] == "mega" and tuple(mega.iters.shape) == (2,)
    assert (mega.iters == 200).all()
    ell = tt.DiagOp(torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"no lane axis.*BatchedOp\.stack"):
        solve_batch(_t(c[:, :3]), ell, _t(b[:, :3]),
                    tt.ConeLayout([tt.rpos(3)]))
    with pytest.raises(TypeError, match="DeviceMesh"):
        solve_batch(*args, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        parallel.shard_batch((_t(c),), object())
    with pytest.raises(RuntimeError, match="multihost.init"):
        parallel.make_mesh(devices="cpu")
    assert not parallel.multihost.is_multihost()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        parallel.multihost.init()          # initialized already: a no-op
        assert not parallel.multihost.is_multihost()
        mesh = parallel.make_mesh(devices="cpu")
        assert parallel.local_mesh({"batch": 1}, "cpu").size() == 1
        with pytest.raises(ValueError, match="needs 2 ranks"):
            parallel.make_mesh(batch=2, devices="cpu")
        (cs,) = parallel.shard_batch((_t(c),), mesh)
        assert torch.equal(cs, _t(c))
        whole = solve_batch(*args, p)
        on_mesh = solve_batch(*args, p, mesh=mesh)
        assert torch.equal(on_mesh.x, whole.x)
        assert torch.equal(on_mesh.iters, whole.iters)
        # the rank's lanes on the batched megakernel (its plain version)
        mega_mesh = solve_batch(*f32, tt.SolverParam(kernel="mega",
                                                     max_iter=200),
                                mesh=mesh)
        assert torch.equal(mega_mesh.x, mega.x)
        prob = parallel.shard_dense_problem(
            tt.ConicProblem(_t(c[0]), tt.DenseOp(_t(a[0])), _t(b[0]), lay),
            mesh)
        assert torch.equal(prob.solve_jit(p).x,
                           tt.solve_jit(_t(c[0]), _t(a[0]), _t(b[0]), lay,
                                        p).x)
        assert torch.equal(prob.a.to_dense(), _t(a[0]))
        ell = tt.BlockedEllOp.from_dense(a[0], block=(m, a.shape[2]),
                                         device="cpu")
        parallel.shard_blocked_ell_problem(
            tt.ConicProblem(_t(c[0]), ell, _t(b[0]), lay), mesh)
        from totsu_tpu_torch.parallel.sharded import (RowShardedOp,
                                                      RowSharding, even_split)
        rows = RowShardedOp(tt.BatchedDenseOp(f32[1]), RowSharding(
            mesh, "row", even_split(mesh, "row", m)))
        with pytest.raises(ValueError, match="kernel='mega'"):
            solve_batch(f32[0], rows, f32[2], lay,
                        tt.SolverParam(kernel="mega", max_iter=200))
    finally:
        dist.destroy_process_group()
    assert sorted(parallel.__all__) == sorted(
        __import__("totsu_tpu.parallel", fromlist=["x"]).__all__)


def test_kernel_auto_keeps_the_host_loop():
    c, a, b, m = lp_batch(lanes=2, seed=8)
    lay = tt.ConeLayout([tt.rpos(m)])
    p = tt.SolverParam(max_iter=500, eps_acc=1e-3, check_period=10,
                       accel="halpern")
    plain = solve_batch(_t(c, torch.float32), _t(a, torch.float32),
                        _t(b, torch.float32), lay, p)
    auto = solve_batch(_t(c, torch.float32), _t(a, torch.float32),
                       _t(b, torch.float32), lay,
                       tt.SolverParam(**{**p.__dict__, "kernel": "auto"}))
    assert torch.equal(plain.x, auto.x)


def test_graphs_only_where_no_kernel_counts_or_host_reads():
    from totsu_tpu_torch.solver import batched
    lp = tt.ConeLayout([tt.zero(2), tt.rpos(3), tt.soc(3), tt.rsoc(4)])
    assert batched._graphable(lp, "cuda")
    assert not batched._graphable(lp, "cpu")
    for f in (tt.expc(1), tt.powc(0.5), tt.psd(3, method="jacobi"),
              tt.psd(3, method="eigh"), tt.custom(2, lambda x: x)):
        assert not batched._graphable(tt.ConeLayout([tt.rpos(2), f]),
                                      "cuda")
    try:
        batched.CUDA_GRAPHS = False
        assert not batched._graphable(lp, "cuda")
    finally:
        batched.CUDA_GRAPHS = True
