"""The pdhg solve of the PyTorch port against the JAX package.

Each problem is made once with numpy and handed to both packages (f64
unless stated). The port's host loop runs the same update, check and
Halpern wrapper as the JAX ``lax.while_loop``, term by term, so in f64
the two agree on the status, the exact iteration count and the solution
to roundoff (x to 1e-8).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.ops.kernels import dual_matvec as dm


def small_lp(n=24, m=60, seed=0):
    """bench.make_lp's shape: random inequalities plus a box."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, n))
    x0 = rng.normal(size=n)
    h = g @ x0 + rng.random(m) + 0.1
    eye = np.eye(n)
    a = np.concatenate([g, eye, -eye], axis=0)
    b = np.concatenate([h, np.full(n, 10.0), np.full(n, 10.0)])
    c = rng.normal(size=n)
    return c, a, b, m + 2 * n


def _both(c, a, b, cone_j, pj, warm=None):
    rj = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                      cone_j, pj, warm_start=warm)
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu")
    warm_t = None if warm is None else tuple(
        torch.from_numpy(np.array(w)) for w in warm)
    rt = tt.solve_jit(ct, at, bt, interop.cone_from_reference(cone_j),
                      interop.param_from_reference(pj), warm_start=warm_t)
    return rj, rt


def test_golden_lp_160_iterations():
    # the reference's committed QEMU log: 160 updates, x to 1e-9
    c = torch.tensor([-1.0, 0.0], dtype=torch.float64)
    a = torch.tensor([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]],
                     dtype=torch.float64)
    b = torch.tensor([6.0, 6.0, 1.0], dtype=torch.float64)
    res = tt.solve(c, a, b, tt.ConeLayout([tt.rpos(3)]),
                   tt.SolverParam(max_iter=100_000))
    assert res.converged
    assert res.iters == 160
    np.testing.assert_allclose(
        res.x.numpy(), [1.9999994251590176, 2.0000004472430635], atol=1e-9)


@pytest.mark.parametrize("kw", [
    dict(eps_acc=1e-3),
    dict(eps_acc=1e-4, accel="halpern", normalize=True, equil_iters=10),
    dict(eps_acc=1e-3, relax=1.6),
], ids=["plain", "halpern_normalize_equil", "relax"])
def test_small_lp_matches_jax(kw):
    c, a, b, m = small_lp()
    pj = jt.SolverParam(max_iter=60_000, check_period=10, **kw)
    rj, rt = _both(c, a, b, jt.ConeLayout([jt.rpos(m)]), pj)
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), rtol=0,
                               atol=1e-8)
    for name in ("cri_pri", "cri_dual", "cri_gap"):
        np.testing.assert_allclose(float(getattr(rt, name)),
                                   float(getattr(rj, name)), rtol=1e-6)


def test_small_lp_matches_jax_f32_bf16_matvec():
    # f32 iterate with bf16 storage of A in the update matvecs: the
    # criteria keep the exact A, so the solve still certifies eps_acc;
    # the f32 sums differ in order, so x is held to 1e-3 and the
    # iteration counts to one check period
    c, a, b, m = small_lp(seed=1)
    kw = dict(max_iter=60_000, check_period=10, eps_acc=1e-2,
              accel="halpern", normalize=True, matvec_dtype="bfloat16")
    rj = jt.solve_jit(jnp.asarray(c, jnp.float32), jnp.asarray(a, jnp.float32),
                      jnp.asarray(b, jnp.float32), jt.ConeLayout([jt.rpos(m)]),
                      jt.SolverParam(**kw))
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=torch.float32)
    rt = tt.solve_jit(ct, at, bt, tt.ConeLayout([tt.rpos(m)]),
                      tt.SolverParam(**kw))
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert abs(rt.iters - int(rj.iters)) <= 10
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-3)


@pytest.mark.parametrize("g,h,status", [
    ([[1.0], [-1.0]], [-5.0, -10.0], tt.SolverStatus.INFEASIBLE),
    ([[1.0], [1.0]], [5.0, 10.0], tt.SolverStatus.UNBOUNDED),
], ids=["infeasible", "unbounded"])
def test_certificates_match_jax(g, h, status):
    # ref totsu/tests/lp.rs test_lp1 / test_lp2 (tests/test_problems.py)
    from totsu_tpu.problems import lp as jlp
    from totsu_tpu_torch.problems import lp as tlp
    param = dict(max_iter=100_000)
    with pytest.raises(jt.SolverError) as ej:
        jlp(c=[1.0], g=g, h=h).solve(jt.SolverParam(**param))
    with pytest.raises(tt.SolverError) as et:
        tlp(c=[1.0], g=g, h=h, device="cpu").solve(tt.SolverParam(**param))
    assert int(et.value.status) == int(ej.value.status) == status
    rj = jlp(c=[1.0], g=g, h=h).solve_jit(jt.SolverParam(**param))
    rt = tlp(c=[1.0], g=g, h=h, device="cpu").solve_jit(tt.SolverParam(**param))
    assert rt.status == int(rj.status)
    assert rt.iters == int(rj.iters)


@pytest.mark.parametrize("accel", ["", "halpern", "restart"])
def test_warm_start_at_solution_stops_at_zero(accel):
    c, a, b, m = small_lp(seed=2)
    pj = jt.SolverParam(max_iter=60_000, eps_acc=1e-3, check_period=10,
                        accel=accel)
    rj, rt = _both(c, a, b, jt.ConeLayout([jt.rpos(m)]), pj)
    assert rt.converged and rt.iters == int(rj.iters)
    rj2, rt2 = _both(c, a, b, jt.ConeLayout([jt.rpos(m)]), pj,
                     warm=(np.asarray(rj.x), np.asarray(rj.y)))
    assert rt2.converged and rt2.iters == int(rj2.iters) == 0
    np.testing.assert_allclose(rt2.x.numpy(), np.asarray(rj2.x), atol=1e-8)


def test_solve_sequence_warm_starts():
    c, a, b, m = small_lp(seed=3)
    cone = tt.ConeLayout([tt.rpos(m)])
    param = tt.SolverParam(max_iter=60_000, eps_acc=1e-3, check_period=10)
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu")
    r1, r2 = tt.solve_sequence([(ct, at, bt, cone), (ct, at, bt, cone)],
                               param)
    assert r1.converged and r2.converged
    assert r1.iters > 0 and r2.iters == 0


def test_dual_matvec_counts_only_launches():
    # the CPU solve goes through the plain version: no launch is counted
    c, a, b, m = small_lp(seed=4)
    before = dm.launches
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu")
    tt.solve_jit(ct, at, bt, tt.ConeLayout([tt.rpos(m)]),
                 tt.SolverParam(max_iter=100, eps_acc=1e-3))
    assert dm.launches == before


@pytest.mark.parametrize("kw,solve_kw", [
    (dict(profile="fast"), dict(row_sharding=object())),
    ({}, dict(row_sharding=object())),
], ids=["fast_row_sharding", "row_sharding"])
def test_unported_features_raise(kw, solve_kw):
    """A row_sharding that is not the port's record (from
    parallel.shard_dense_problem) is a TypeError, under either profile."""
    c, a, b, m = small_lp(seed=5)
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu")
    with pytest.raises(TypeError, match="RowSharding"):
        tt.solve(ct, at, bt, tt.ConeLayout([tt.rpos(m)]),
                 tt.SolverParam(max_iter=10, **kw), **solve_kw)


def test_param_from_reference_copies_every_field():
    pj = jt.SolverParam(max_iter=123, eps_acc=1e-4, eps_inf=1e-5,
                        check_period=7, relax=1.3, equil_iters=3,
                        accel="halpern", normalize=True,
                        matvec_dtype="bfloat16", kernel="mega")
    pt = interop.param_from_reference(pj)
    import dataclasses
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_effective_eps_inf_matches_jax(dtype):
    from totsu_tpu.solver.params import effective_eps_inf as jeff
    from totsu_tpu_torch.solver.params import effective_eps_inf as teff
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    for p in (dict(), dict(eps_inf=1e-9)):
        assert teff(tt.SolverParam(**p), dtype) == jeff(jt.SolverParam(**p),
                                                        jdt)
