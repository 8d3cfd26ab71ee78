"""f32 robustness of the PyTorch port against the JAX package: the twin
of ``tests/test_f32.py`` (certificates and convergence in f32), on the
CPU.

Each instance is made once with numpy and solved in f32 by both packages
(the dtype follows the data). The port must reach the JAX package's
status and meet the JAX test's own contract; f32 iteration counts may
differ by rounding between the two, so they are not compared (the f64
twins hold them equal).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.solver.params import effective_eps_inf
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

F32 = np.float32

INFEAS = ([1.0], [[1.0], [-1.0]], [-5.0, -10.0])   # ref totsu/tests/lp.rs:44
UNBDD = ([1.0], [[1.0], [1.0]], [5.0, 10.0])       # ref totsu/tests/lp.rs:81


def _solve32(c, g, h, lay_j, **kw):
    """(JAX result, port result) of one f32 solve."""
    pj = jt.SolverParam(**{"max_iter": 500_000, "check_period": 10, **kw})
    args = [np.asarray(v, F32) for v in (c, g, h)]
    rj = jt.solve_jit(*(jnp.asarray(v) for v in args), lay_j, pj)
    rt = tt.solve_jit(*interop.problem_from_numpy(*args, device="cpu",
                                                  dtype=torch.float32),
                      interop.cone_from_reference(lay_j),
                      interop.param_from_reference(pj))
    return rj, rt


def _same_status(rj, rt, want):
    assert int(rj.status) == want
    assert rt.status == want, (rt.status, rt.iters)


@pytest.mark.parametrize("method", ["pdhg", "direct"])
@pytest.mark.parametrize("accel", ["", "halpern"])
def test_f32_infeasible_certificate(method, accel):
    rj, rt = _solve32(*INFEAS, jt.ConeLayout([jt.rpos(2)]), method=method,
                      accel=accel)
    assert rt.x.dtype == torch.float32
    _same_status(rj, rt, tt.SolverStatus.INFEASIBLE)


@pytest.mark.parametrize("method", ["pdhg", "direct"])
@pytest.mark.parametrize("accel", ["", "halpern"])
def test_f32_unbounded_certificate(method, accel):
    rj, rt = _solve32(*UNBDD, jt.ConeLayout([jt.rpos(2)]), method=method,
                      accel=accel)
    _same_status(rj, rt, tt.SolverStatus.UNBOUNDED)


def test_f32_certificates_under_normalize_and_equil():
    for data, want in ((INFEAS, tt.SolverStatus.INFEASIBLE),
                       (UNBDD, tt.SolverStatus.UNBOUNDED)):
        rj, rt = _solve32(*data, jt.ConeLayout([jt.rpos(2)]),
                          normalize=True, equil_iters=10)
        _same_status(rj, rt, want)


def test_f32_random_lp_converges_to_1e3():
    rng = np.random.default_rng(0)
    n = 50
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    c = rng.normal(size=n)
    rj, rt = _solve32(c, g, h, jt.ConeLayout([jt.rpos(2 * n)]),
                      eps_acc=1e-3)
    _same_status(rj, rt, tt.SolverStatus.CONVERGED)
    # the residual in f64 from the f32 solution
    x = rt.x.double().numpy()
    cri = np.linalg.norm(np.maximum(g @ x - h, 0)) / (1 + np.linalg.norm(h))
    assert cri <= 2e-3


def test_f32_fast_profile_converges():
    rng = np.random.default_rng(1)
    n = 60
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    eye = np.eye(n)
    g = np.concatenate([g, eye, -eye])
    h = np.concatenate([h, np.full(2 * n, 10.0)])
    c = rng.normal(size=n)
    rj, rt = _solve32(c, g, h, jt.ConeLayout([jt.rpos(4 * n)]),
                      eps_acc=1e-3, profile="fast")
    _same_status(rj, rt, tt.SolverStatus.CONVERGED)
    assert rt.x.dtype == torch.float32


def _unbounded_socp():
    """The unbounded SOCP whose f32 ray residual floors near 8e-6, as
    numpy data and the JAX layout."""
    rng = np.random.default_rng(5)
    n = 60
    gs = [rng.normal(size=(20, n)) for _ in range(3)]
    hs = [rng.normal(size=20) for _ in range(3)]
    cs = [rng.normal(size=n) * 0.1 for _ in range(3)]
    sp = jt.problems.socp(rng.normal(size=n), gs, hs, cs, [5.0] * 3)
    return np.array(sp.c), np.array(sp.a.a), np.array(sp.b), sp.cone


def test_f32_explicit_eps_inf_is_honored():
    """An explicit eps_inf is used verbatim, not raised to the f32 floor:
    either the budget runs out above 1e-12 (EXCESS_ITER) or UNBOUNDED is
    certified at 1e-12 (an exactly zero ray residual certifies at any
    tolerance); the floored default certifies strictly earlier."""
    c, g, h, cone = _unbounded_socp()
    rj, rt = _solve32(c, g, h, cone, max_iter=30_000, check_period=20,
                      eps_inf=1e-12)
    ok = (tt.SolverStatus.EXCESS_ITER, tt.SolverStatus.UNBOUNDED)
    assert int(rj.status) in ok and rt.status in ok
    if rt.status == tt.SolverStatus.UNBOUNDED:
        assert float(rt.cri_unbdd) <= 1e-12
    rj2, rt2 = _solve32(c, g, h, cone, max_iter=30_000, check_period=20)
    _same_status(rj2, rt2, tt.SolverStatus.UNBOUNDED)
    assert rt.iters > rt2.iters


def test_effective_eps_inf_sentinel():
    """None is the unset sentinel; every explicit float is verbatim; the
    port resolves as the JAX package does for each dtype."""
    f32 = torch.float32
    assert effective_eps_inf(tt.SolverParam(), f32) == pytest.approx(
        100 * float(torch.finfo(f32).eps))
    assert effective_eps_inf(tt.SolverParam(), torch.float64) == 1e-6
    assert effective_eps_inf(tt.SolverParam(eps_inf=1e-6), f32) == 1e-6
    assert effective_eps_inf(tt.SolverParam(eps_inf=1e-12), f32) == 1e-12
    assert effective_eps_inf(tt.SolverParam(), torch.bfloat16) == 1e-4
    from totsu_tpu.solver.params import effective_eps_inf as jeff
    for p in (jt.SolverParam(), jt.SolverParam(eps_inf=1e-6),
              jt.SolverParam(eps_inf=1e-12)):
        for jdt, tdt in ((jnp.float32, f32), (jnp.float64, torch.float64),
                         (jnp.bfloat16, torch.bfloat16)):
            assert effective_eps_inf(interop.param_from_reference(p),
                                     tdt) == pytest.approx(jeff(p, jdt))


def test_f32_ns_projection_rank1_accuracy():
    """The scaled Newton-Schulz schedule keeps its margin: (near-)rank-1
    f32 blocks project to within 5e-6 of the exact f64 projection, and
    the port's 'ns' agrees with the JAX package's to f32 rounding."""
    from totsu_tpu.ops.sympack import psd_part_ns as jns
    from totsu_tpu_torch.ops.sympack import psd_part_ns
    rng = np.random.default_rng(3)
    k = 32
    mats = []
    for _ in range(25):
        v = rng.normal(size=k)
        v /= np.linalg.norm(v)
        mats.append(np.outer(v, v))
        e = rng.normal(size=(k, k)) * 1e-4
        mats.append(np.outer(v, v) + (e + e.T) / 2)
    x32 = np.stack(mats).astype(F32)
    got = psd_part_ns(torch.from_numpy(x32)).double().numpy()
    w, vecs = np.linalg.eigh(np.stack(mats))
    exact = np.einsum("bik,bk,bjk->bij", vecs, np.maximum(w, 0.0), vecs)
    assert np.abs(got - exact).max() < 5e-6
    got_j = np.asarray(jns(jnp.asarray(x32)), dtype=np.float64)
    assert np.abs(got - got_j).max() < 5e-6


@pytest.mark.parametrize("method", ["pdhg", "direct"])
def test_f32_unbounded_socp_certificate(method):
    """An unbounded SOCP whose f32 ray residual floors above the default
    eps_inf certifies UNBOUNDED through the f32 floor (and in f64 at the
    unfloored 1e-6)."""
    c, g, h, cone = _unbounded_socp()
    rj, rt = _solve32(c, g, h, cone, max_iter=100_000, check_period=20,
                      method=method)
    _same_status(rj, rt, tt.SolverStatus.UNBOUNDED)
    pt = tt.SolverParam(max_iter=100_000, check_period=20, method=method)
    r64 = tt.solve_jit(*interop.problem_from_numpy(c, g, h, device="cpu"),
                       interop.cone_from_reference(cone), pt)
    assert r64.status == tt.SolverStatus.UNBOUNDED
