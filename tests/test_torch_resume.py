"""Checkpoint / resume, chunked solves, progress logging and the Solver
facade of the PyTorch port against the JAX package.

Twins of the JAX package's resume tests (``tests/test_solver.py``,
``tests/test_direct.py``, ``tests/test_megakernel.py``): each problem is
made once with numpy and handed to both packages in f64. Within the port
a chunked or two-part solve equals the uninterrupted one (the same
iterations, x to 1e-12, as the JAX tests ask); against the JAX package the
iterations agree exactly and x to 1e-8. A JAX checkpoint carried across
with ``interop.resume_state_from_reference`` continues in the port on the
JAX package's own path.
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.solver.conic import solve as jsolve, solve_jit as jsolve_jit
from totsu_tpu_torch import interop
from totsu_tpu_torch.solver import conic as tconic
from totsu_tpu_torch.solver import direct as tdirect
from totsu_tpu_torch.solver.params import SolverError, SolverStatus


def _golden():
    c = np.array([-1.0, 0.0])
    a = np.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = np.array([6.0, 6.0, 1.0])
    return c, a, b, jt.ConeLayout([jt.rpos(3)])


def _boxed_lp(n, seed):
    """tests/test_solver.py's feasible and bounded random LP."""
    rng = np.random.default_rng(seed)
    m = 2 * n
    g = rng.normal(size=(m, n))
    h = g @ rng.normal(size=n) + rng.random(m) + 0.1
    g = np.concatenate([g, np.eye(n), -np.eye(n)])
    h = np.concatenate([h, np.full(n, 10.0), np.full(n, 10.0)])
    c = rng.normal(size=n)
    return c, g, h, jt.ConeLayout([jt.rpos(g.shape[0])])


def _t(c, a, b, lay, dtype=torch.float64):
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=dtype)
    return ct, at, bt, interop.cone_from_reference(lay)


def _j(c, a, b):
    return jnp.asarray(c), jnp.asarray(a), jnp.asarray(b)


def _p(**kw):
    return tt.SolverParam(**kw), jt.SolverParam(**kw)


def _x_close(rt, rj, atol=1e-8):
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=atol)


def test_checkpoint_resume_exact():
    c, a, b, lay = _golden()
    ct, at, bt, tl = _t(c, a, b, lay)
    full = tt.solve_jit(ct, at, bt, tl, tt.SolverParam(max_iter=100_000))
    part1 = tt.solve_jit(ct, at, bt, tl,
                         tt.SolverParam(max_iter=80, return_state=True))
    assert part1.status == SolverStatus.EXCESS_ITER
    part2 = tt.solve_jit(ct, at, bt, tl, tt.SolverParam(max_iter=100_000),
                         resume_state=part1.state)
    assert part2.status == SolverStatus.CONVERGED
    assert part1.iters + part2.iters == full.iters == 160
    np.testing.assert_allclose(part2.x.numpy(), full.x.numpy(), atol=1e-12)
    # the JAX package's own split
    pj1 = jsolve_jit(*_j(c, a, b), lay,
                     jt.SolverParam(max_iter=80, return_state=True))
    pj2 = jsolve_jit(*_j(c, a, b), lay, jt.SolverParam(max_iter=100_000),
                     resume_state=pj1.state)
    assert part2.iters == int(pj2.iters)
    _x_close(part2, pj2)


def test_solve_chunked_matches_single_dispatch():
    c, a, b, lay = _golden()
    ct, at, bt, tl = _t(c, a, b, lay)
    full = tt.solve(ct, at, bt, tl, tt.SolverParam(max_iter=100_000))
    chunked = tt.solve(ct, at, bt, tl, tt.SolverParam(max_iter=100_000),
                       chunk_iters=50)
    assert chunked.iters == full.iters == 160
    assert chunked.state is None
    np.testing.assert_allclose(chunked.x.numpy(), full.x.numpy(),
                               atol=1e-12)
    cj = jsolve(*_j(c, a, b), lay, jt.SolverParam(max_iter=100_000),
                chunk_iters=50)
    _x_close(chunked, cj)
    # the direct engine chunks too
    ch_d = tt.solve(ct, at, bt, tl,
                    tt.SolverParam(max_iter=100_000, method="direct"),
                    chunk_iters=40)
    cj_d = jsolve(*_j(c, a, b), lay,
                  jt.SolverParam(max_iter=100_000, method="direct"),
                  chunk_iters=40)
    assert ch_d.status == SolverStatus.CONVERGED
    assert ch_d.iters == int(cj_d.iters)
    _x_close(ch_d, cj_d)
    # the overall max_iter cap holds exactly across chunks: 100 is not a
    # multiple of 40, and the tail chunk is shortened
    with pytest.raises(SolverError) as err:
        tt.solve(ct, at, bt, tl, tt.SolverParam(max_iter=100),
                 chunk_iters=40)
    assert err.value.status == SolverStatus.EXCESS_ITER
    seen = []
    real = tconic.solve_jit
    tconic.solve_jit = lambda *a_, **k_: seen.append(a_[4].max_iter) \
        or real(*a_, **k_)
    try:
        with pytest.raises(SolverError):
            tt.solve(ct, at, bt, tl, tt.SolverParam(max_iter=100),
                     chunk_iters=40)
    finally:
        tconic.solve_jit = real
    assert seen == [40, 40, 20]
    part = tt.solve_jit(ct, at, bt, tl,
                        tt.SolverParam(max_iter=100, return_state=True))
    assert part.iters == 100 and part.state.k == 100


@pytest.mark.parametrize("chunk", [0, -5])
def test_solve_chunked_rejects_nonpositive_chunks(chunk):
    c, a, b, lay = _golden()
    with pytest.raises(ValueError, match="chunk_iters"):
        tt.solve(*_t(c, a, b, lay), tt.SolverParam(max_iter=100),
                 chunk_iters=chunk)


@pytest.mark.parametrize("method,accel", [
    ("pdhg", "halpern"), ("direct", "halpern"), ("pdhg", "restart")])
def test_solve_chunked_halpern_exact(method, accel):
    c, g, h, lay = _boxed_lp(n=40, seed=5)
    pt, pj = _p(max_iter=200_000, eps_acc=1e-6, check_period=20,
                accel=accel, method=method)
    ct, gt, ht, tl = _t(c, g, h, lay)
    full = tt.solve(ct, gt, ht, tl, pt)
    chunked = tt.solve(ct, gt, ht, tl, pt, chunk_iters=100)
    assert full.iters > 100  # the test actually chunks
    assert chunked.iters == full.iters
    np.testing.assert_allclose(chunked.x.numpy(), full.x.numpy(),
                               atol=1e-12)
    cj = jsolve(*_j(c, g, h), lay, pj, chunk_iters=100)
    assert chunked.iters == int(cj.iters)
    _x_close(chunked, cj)


COMBOS = [("pdhg", "", 1e-3), ("pdhg", "halpern", 1e-6),
          ("pdhg", "restart", 1e-6), ("direct", "", 1e-6),
          ("direct", "halpern", 1e-6)]


@pytest.mark.parametrize("method,accel,eps", COMBOS,
                         ids=[f"{m}-{a or 'plain'}" for m, a, _ in COMBOS])
def test_resume_state_exact_across_engines_and_accels(method, accel, eps):
    c, g, h, lay = _boxed_lp(n=30, seed=9)
    ct, gt, ht, tl = _t(c, g, h, lay)
    kw = dict(eps_acc=eps, check_period=20, method=method, accel=accel)
    full = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=200_000,
                                                        **kw))
    part1 = tt.solve_jit(ct, gt, ht, tl,
                         tt.SolverParam(max_iter=60, return_state=True, **kw))
    assert part1.status == SolverStatus.EXCESS_ITER
    st = part1.state
    assert isinstance(st, tt.ResumeState)
    assert st.engine == method and st.accel == accel
    assert st.k == part1.iters == 60 and isinstance(st.k, int)
    part2 = tt.solve_jit(ct, gt, ht, tl,
                         tt.SolverParam(max_iter=200_000, **kw),
                         resume_state=st)
    assert part1.iters + part2.iters == full.iters
    np.testing.assert_allclose(part2.x.numpy(), full.x.numpy(), atol=1e-12)
    rj = jsolve_jit(*_j(c, g, h), lay, jt.SolverParam(max_iter=200_000,
                                                       **kw))
    assert full.iters == int(rj.iters)
    _x_close(part2, rj)


def test_resume_state_aux_keys_match_jax():
    # every key of the JAX checkpoint's aux, less the indirect engine's
    # CG warm start; the port adds the cache's step counts
    c, g, h, lay = _boxed_lp(n=10, seed=2)
    ct, gt, ht, tl = _t(c, g, h, lay)
    for method, accel in (("pdhg", ""), ("pdhg", "halpern"),
                          ("pdhg", "restart"), ("direct", ""),
                          ("direct", "halpern")):
        pt, pj = _p(max_iter=40, check_period=20, method=method, accel=accel,
                    return_state=True)
        rt = tt.solve_jit(ct, gt, ht, tl, pt)
        rj = jsolve_jit(*_j(c, g, h), lay, pj)
        want = set(rj.state.aux) - {"ws"}
        if method == "direct":
            want |= {"ns_steps", "refine_steps"}
        assert set(rt.state.aux) == want, (method, accel)


def test_resume_state_direct_carries_caches(monkeypatch):
    """The direct engine's checkpoint carries the cached Cholesky factor
    and the Sherman-Morrison border, and a resumed solve builds neither."""
    c, g, h, lay = _boxed_lp(n=25, seed=11)
    ct, gt, ht, tl = _t(c, g, h, lay)
    p = tt.SolverParam(max_iter=30, method="direct", accel="halpern",
                       return_state=True)
    part = tt.solve_jit(ct, gt, ht, tl, p)
    aux = part.state.aux
    assert {"chol_c", "gh", "denom", "anchor", "ke", "z"} <= set(aux)
    calls = {"spd_cache": 0, "cholesky": 0, "newton_schulz_inverse": 0}

    def counted(owner, name):
        real = getattr(owner, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(owner, name, call)

    counted(tdirect, "spd_cache")
    counted(tdirect, "newton_schulz_inverse")
    counted(torch.linalg, "cholesky")
    again = tt.solve_jit(ct, gt, ht, tl,
                         tt.SolverParam(max_iter=30, method="direct",
                                        accel="halpern"),
                         resume_state=part.state)
    assert again.iters == 30
    assert calls == {"spd_cache": 0, "cholesky": 0,
                     "newton_schulz_inverse": 0}
    # the counters do see a cold solve build its cache
    tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=30,
                                                method="direct"))
    assert calls["spd_cache"] == 1 and calls["cholesky"] == 1


def test_resume_state_direct_f32_carries_the_inverse(monkeypatch):
    c, g, h, lay = _boxed_lp(n=12, seed=3)
    ct, gt, ht, tl = _t(c, g, h, lay, dtype=torch.float32)
    kw = dict(method="direct", accel="halpern", eps_acc=1e-4,
              check_period=10)
    full = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=20_000,
                                                        **kw))
    part = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(
        max_iter=30, return_state=True, **kw))
    aux = part.state.aux
    assert "prec" in aux and "chol_c" not in aux
    assert aux["refine_steps"] == 2 and aux["ns_steps"] > 0
    monkeypatch.setattr(tdirect, "newton_schulz_inverse", None)
    rest = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=20_000,
                                                        **kw),
                        resume_state=part.state)
    assert part.iters + rest.iters == full.iters
    assert torch.equal(rest.x, full.x)


def test_resume_state_direct_cache_of_another_kind_raises():
    # a checkpoint whose cache takes other refinement steps than this
    # solve's cannot be honoured
    c, g, h, lay = _boxed_lp(n=6, seed=3)
    ct, gt, ht, tl = _t(c, g, h, lay, dtype=torch.float32)
    p = tt.SolverParam(max_iter=20, method="direct", return_state=True)
    st = tt.solve_jit(ct, gt, ht, tl, p).state
    bad = tt.ResumeState(u=st.u, v=st.v, k=st.k,
                         aux={**st.aux, "refine_steps": 0}, engine="direct")
    with pytest.raises(ValueError, match="refinement steps"):
        tt.solve_jit(ct, gt, ht, tl, p, resume_state=bad)


TERMINAL = [("pdhg", "halpern"), ("pdhg", "restart"), ("direct", "halpern"),
            ("pdhg", ""), ("direct", "")]


@pytest.mark.parametrize("method,accel", TERMINAL,
                         ids=[f"{m}-{a or 'plain'}" for m, a in TERMINAL])
def test_terminal_checkpoint_resume_is_frozen(method, accel):
    """Resuming a terminal checkpoint is a no-op: 0 iterations and a
    bit-identical solution and criteria."""
    rng = np.random.default_rng(4)
    n = 24
    g = rng.normal(size=(2 * n, n))
    h = np.concatenate([g @ rng.normal(size=n) + rng.random(2 * n) + 0.1,
                        np.full(2 * n, 10.0)])
    g = np.concatenate([g, np.eye(n), -np.eye(n)])
    c = rng.normal(size=n)
    ct, gt, ht, tl = _t(c, g, h, jt.ConeLayout([jt.rpos(4 * n)]))
    p = tt.SolverParam(max_iter=200_000, method=method, accel=accel,
                       eps_acc=1e-4 if accel == "" else 1e-6,
                       check_period=10, return_state=True)
    r1 = tt.solve_jit(ct, gt, ht, tl, p)
    assert r1.status == SolverStatus.CONVERGED
    r2 = tt.solve_jit(ct, gt, ht, tl, p, resume_state=r1.state)
    assert r2.iters == 0 and r2.status == r1.status
    assert torch.equal(r2.x, r1.x) and torch.equal(r2.y, r1.y)
    for f in ("cri_pri", "cri_dual", "cri_gap", "cri_unbdd", "cri_infeas"):
        assert torch.equal(getattr(r2, f), getattr(r1, f)), f
    assert r2.state.k == r1.state.k


def test_direct_checkpoint_resume():
    rng = np.random.default_rng(12)
    n = 20
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    c = rng.normal(size=n)
    lay = jt.ConeLayout([jt.rpos(2 * n)])
    ct, gt, ht, tl = _t(c, g, h, lay)
    full = tt.solve_jit(ct, gt, ht, tl,
                        tt.SolverParam(max_iter=200_000, method="direct"))
    part1 = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(
        max_iter=40, method="direct", return_state=True))
    assert part1.status == SolverStatus.EXCESS_ITER
    part2 = tt.solve_jit(ct, gt, ht, tl,
                         tt.SolverParam(max_iter=200_000, method="direct"),
                         resume_state=part1.state)
    assert part2.status == SolverStatus.CONVERGED
    assert part1.iters + part2.iters == full.iters
    np.testing.assert_allclose(part2.x.numpy(), full.x.numpy(), atol=1e-12)
    rj = jsolve_jit(*_j(c, g, h), lay,
                    jt.SolverParam(max_iter=200_000, method="direct"))
    assert full.iters == int(rj.iters)
    _x_close(part2, rj)


def test_resume_state_cross_engine_raises_clearly():
    c = np.array([1.0, 1.0])
    g = np.array([[-1.0, 0.0], [0.0, -1.0], [0.0, 0.0]])
    h = np.array([-2.0, -2.0, 1.0])
    ct, gt, ht, tl = _t(c, g, h, jt.ConeLayout([jt.rpos(3)]))
    pd = tt.solve_jit(ct, gt, ht, tl,
                      tt.SolverParam(max_iter=50, return_state=True))
    dr = tt.solve_jit(ct, gt, ht, tl,
                      tt.SolverParam(max_iter=50, method="direct",
                                     return_state=True))
    with pytest.raises(ValueError, match="pdhg engine"):
        tt.solve_jit(ct, gt, ht, tl,
                     tt.SolverParam(max_iter=50, method="direct"),
                     resume_state=pd.state)
    with pytest.raises(ValueError, match="direct engine"):
        tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=50),
                     resume_state=dr.state)
    # legacy bare (u, v) tuples are told apart by their shape
    with pytest.raises(ValueError, match="pdhg engine"):
        tt.solve_jit(ct, gt, ht, tl,
                     tt.SolverParam(max_iter=50, method="direct"),
                     resume_state=(pd.state.u, pd.state.v))
    with pytest.raises(ValueError, match="direct engine"):
        tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=50),
                     resume_state=(dr.state.u, dr.state.v))


def test_legacy_tuple_and_accel_mismatch_start_a_fresh_epoch():
    # a bare (u, v) resumes at k = 0 with a fresh epoch, as does a
    # checkpoint of another accel; both still converge to the same point
    c, g, h, lay = _boxed_lp(n=10, seed=6)
    ct, gt, ht, tl = _t(c, g, h, lay)
    kw = dict(eps_acc=1e-6, check_period=20, max_iter=200_000)
    part = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(
        accel="halpern", return_state=True, **dict(kw, max_iter=60)))
    legacy = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(accel="halpern",
                                                          return_state=True,
                                                          **kw),
                          resume_state=(part.state.u, part.state.v))
    other = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(accel="restart",
                                                         **kw),
                         resume_state=part.state)
    full = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(accel="halpern",
                                                        **kw))
    assert legacy.converged and other.converged
    assert legacy.state.k == legacy.iters
    for r in (legacy, other):
        np.testing.assert_allclose(r.x.numpy(), full.x.numpy(), atol=1e-4)


def test_resume_state_on_another_device_or_dtype_raises():
    c, a, b, lay = _golden()
    ct, at, bt, tl = _t(c, a, b, lay)
    part = tt.solve_jit(ct, at, bt, tl,
                        tt.SolverParam(max_iter=40, return_state=True))
    f32 = tt.ResumeState(
        u=tuple(x.float() for x in part.state.u),
        v=tuple(x.float() for x in part.state.v), k=40, aux={})
    with pytest.raises(ValueError, match="resume_state holds"):
        tt.solve_jit(ct, at, bt, tl, tt.SolverParam(max_iter=40),
                     resume_state=f32)
    meta = tt.ResumeState(
        u=tuple(x.to("meta") for x in part.state.u), v=part.state.v, k=40,
        aux={})
    with pytest.raises(ValueError, match="resume_state holds"):
        tt.solve_jit(ct, at, bt, tl, tt.SolverParam(max_iter=40),
                     resume_state=meta)


def test_mega_checkpoint_resume_matches_xla():
    """return_state / resume_state through kernel='mega': on the CPU the
    port's kernel runs its plain version, the JAX kernel interprets; the
    split solve walks the uninterrupted path, with an empty aux."""
    rng = np.random.default_rng(7)
    n, m = 24, 60
    g = rng.normal(size=(m, n))
    h = g @ rng.normal(size=n) + rng.random(m) + 0.1
    a = np.concatenate([g, np.eye(n), -np.eye(n)]).astype(np.float32)
    b = np.concatenate([h, np.full(2 * n, 10.0)]).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    lay = jt.ConeLayout([jt.rpos(m + 2 * n)])
    ct, at, bt, tl = _t(c, a, b, lay, dtype=torch.float32)
    kw = dict(eps_acc=1e-4, check_period=20, kernel="mega")
    full = tt.solve_jit(ct, at, bt, tl, tt.SolverParam(max_iter=200_000,
                                                        **kw))
    part1 = tt.solve_jit(ct, at, bt, tl, tt.SolverParam(
        max_iter=100, return_state=True, **kw))
    assert part1.status == SolverStatus.EXCESS_ITER
    assert part1.state.aux == {} and part1.state.k == 100
    part2 = tt.solve_jit(ct, at, bt, tl, tt.SolverParam(max_iter=200_000,
                                                         **kw),
                         resume_state=part1.state)
    assert part2.status == SolverStatus.CONVERGED
    assert part1.iters + part2.iters == full.iters
    assert torch.equal(part2.x, full.x)
    jargs = (jnp.asarray(c), jnp.asarray(a), jnp.asarray(b))
    pj1 = jsolve_jit(*jargs, lay, jt.SolverParam(max_iter=100,
                                                 return_state=True, **kw))
    pj2 = jsolve_jit(*jargs, lay, jt.SolverParam(max_iter=200_000, **kw),
                     resume_state=pj1.state)
    assert part2.iters == int(pj2.iters)
    np.testing.assert_allclose(part2.x.numpy(), np.asarray(pj2.x),
                               atol=1e-4)


def test_mega_resumes_a_host_loop_checkpoint_from_the_taken_pair(
        monkeypatch):
    # a Halpern host-loop checkpoint resumed on the megakernel seeds it
    # with the taken pair (state.u, state.v), checked at the start
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    c, g, h, lay = _boxed_lp(n=10, seed=8)
    ct, gt, ht, tl = _t(c, g, h, lay, dtype=torch.float32)
    kw = dict(eps_acc=1e-4, check_period=20, accel="halpern")
    part = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(
        max_iter=60, return_state=True, **kw))
    seen = []
    real = mk.solve_mega
    monkeypatch.setattr(mk, "solve_mega", lambda *a_, **k_: seen.append(
        (a_[7], a_[8], k_["check_at_start"])) or real(*a_, **k_))
    out = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(
        max_iter=20_000, kernel="mega", return_state=True, **kw),
        resume_state=part.state)
    (u0, v0, at_start), = seen
    assert at_start
    assert all(x is y for x, y in zip(u0, part.state.u))
    assert all(x is y for x, y in zip(v0, part.state.v))
    assert out.converged and out.state.k == 60 + out.iters
    assert out.state.aux == {}


# ---- a JAX checkpoint continues in the port

CROSS = [("pdhg", "halpern"), ("pdhg", "restart"), ("direct", ""),
         ("direct", "halpern")]


@pytest.mark.parametrize("method,accel", CROSS,
                         ids=[f"{m}-{a or 'plain'}" for m, a in CROSS])
def test_jax_checkpoint_resumes_in_the_port(method, accel, monkeypatch):
    c, g, h, lay = _boxed_lp(n=30, seed=9)
    kw = dict(eps_acc=1e-6, check_period=20, method=method, accel=accel)
    pj1 = jsolve_jit(*_j(c, g, h), lay,
                     jt.SolverParam(max_iter=60, return_state=True, **kw))
    assert int(pj1.state.k) == 60
    pj2 = jsolve_jit(*_j(c, g, h), lay, jt.SolverParam(max_iter=200_000,
                                                       **kw),
                     resume_state=pj1.state)
    state = interop.resume_state_from_reference(pj1.state, device="cpu")
    assert state.k == 60 and state.engine == method
    assert "ws" not in state.aux
    if method == "direct":
        # the carried factor is the port's lower one
        lower = state.aux["chol_c"]
        assert torch.equal(lower, torch.tril(lower))
        monkeypatch.setattr(tdirect, "spd_cache", None)
    ct, gt, ht, tl = _t(c, g, h, lay)
    rt = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=200_000,
                                                      **kw),
                      resume_state=state)
    assert rt.status == int(pj2.status) == SolverStatus.CONVERGED
    assert rt.iters == int(pj2.iters)
    _x_close(rt, pj2)


def test_jax_f32_checkpoint_carries_the_newton_schulz_inverse(monkeypatch):
    c, g, h, lay = _boxed_lp(n=12, seed=3)
    kw = dict(method="direct", accel="halpern", eps_acc=1e-4,
              check_period=10)
    f32 = [np.asarray(x, np.float32) for x in (c, g, h)]
    jargs = [jnp.asarray(x) for x in f32]
    pj1 = jsolve_jit(*jargs, lay, jt.SolverParam(max_iter=30,
                                                 return_state=True, **kw))
    pj2 = jsolve_jit(*jargs, lay, jt.SolverParam(max_iter=20_000, **kw),
                     resume_state=pj1.state)
    state = interop.resume_state_from_reference(pj1.state, device="cpu")
    np.testing.assert_array_equal(state.aux["prec"].numpy(),
                                  np.asarray(pj1.state.aux["prec"]))
    assert state.aux["prec"].dtype == torch.float32
    monkeypatch.setattr(tdirect, "spd_cache", None)
    ct, gt, ht, tl = _t(*f32, lay, dtype=torch.float32)
    rt = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=20_000, **kw),
                      resume_state=state)
    # f32: the sums run in other orders, so within two check periods
    assert rt.status == int(pj2.status) == SolverStatus.CONVERGED
    assert abs(rt.iters - int(pj2.iters)) <= 2 * kw["check_period"]
    xj = np.asarray(pj2.x, np.float64)
    np.testing.assert_allclose(rt.x.double().numpy(), xj, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(xj).max()))


def test_resume_state_from_reference_dtype_and_device():
    c, a, b, lay = _golden()
    pj = jsolve_jit(*_j(c, a, b), lay,
                    jt.SolverParam(max_iter=40, return_state=True,
                                   accel="halpern"))
    st = interop.resume_state_from_reference(pj.state, device="cpu",
                                             dtype="float32")
    assert all(x.dtype == torch.float32 for x in st.u)
    assert st.aux["ke"] == int(pj.state.aux["ke"])
    assert isinstance(st.aux["status"], int)
    assert isinstance(st.aux["au"], tuple) and len(st.aux["au"]) == 4


# ---- progress logging


def _lines(text):
    return [ln for ln in text.splitlines() if re.match(r"^\d+: ", ln)]


@pytest.mark.parametrize("accel", ["", "halpern", "restart"])
def test_log_lines_match_jax(accel, capfd):
    c, g, h, lay = _boxed_lp(n=8, seed=1)
    pt, pj = _p(max_iter=2_000, eps_acc=1e-6, check_period=10,
                log_period=50, accel=accel)
    rj = jsolve_jit(*_j(c, g, h), lay, pj)
    int(rj.iters)
    want = _lines(capfd.readouterr().out)
    rt = tt.solve_jit(*_t(c, g, h, lay), pt)
    got = _lines(capfd.readouterr().out)
    assert rt.iters == int(rj.iters)
    assert len(got) >= 3 and got == want
    ks = [int(ln.split(":")[0]) for ln in got]
    assert all((k - 10) % 50 < 10 for k in ks)


def test_log_lines_continue_across_a_resume(capfd):
    c, g, h, lay = _boxed_lp(n=8, seed=1)
    ct, gt, ht, tl = _t(c, g, h, lay)
    p = tt.SolverParam(max_iter=600, check_period=10, log_period=50,
                       accel="halpern", return_state=True)
    tt.solve_jit(ct, gt, ht, tl, p)
    whole = _lines(capfd.readouterr().out)
    part = tt.solve_jit(ct, gt, ht, tl,
                        tt.SolverParam(**{**p.__dict__, "max_iter": 200}))
    tt.solve_jit(ct, gt, ht, tl,
                 tt.SolverParam(**{**p.__dict__, "max_iter": 400}),
                 resume_state=part.state)
    assert _lines(capfd.readouterr().out) == whole


def test_unlogged_and_direct_solves_print_nothing(capfd):
    c, g, h, lay = _boxed_lp(n=8, seed=1)
    ct, gt, ht, tl = _t(c, g, h, lay)
    tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=200,
                                                 check_period=10))
    tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(
        max_iter=200, check_period=10, method="direct", log_period=10))
    assert _lines(capfd.readouterr().out) == []


def test_logging_adds_one_read_on_a_logged_check_only(monkeypatch):
    # the host reads per check: one (the status) unlogged, two on a
    # logged check
    c, g, h, lay = _boxed_lp(n=8, seed=1)
    ct, gt, ht, tl = _t(c, g, h, lay)
    reads = []
    real_item, real_tolist = torch.Tensor.item, torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda t: reads.append("item") or real_item(t))
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda t: reads.append("tolist") or real_tolist(t))
    tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=100,
                                                 check_period=10))
    assert reads == ["item"] * 10
    reads.clear()
    tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(max_iter=100,
                                                 check_period=10,
                                                 log_period=50))
    assert reads.count("item") == 10 and reads.count("tolist") == 2


def test_mega_auto_logging_warns_and_fast_profile_routes(monkeypatch):
    """kernel='auto' with log_period > 0 does not lose the kernel
    silently: it warns, and the fast profile routes logged solves to the
    direct engine."""
    rng = np.random.default_rng(4)
    n, m = 24, 60
    g = rng.normal(size=(m, n))
    h = g @ rng.normal(size=n) + rng.random(m) + 0.1
    a = np.concatenate([g, np.eye(n), -np.eye(n)]).astype(np.float32)
    b = np.concatenate([h, np.full(2 * n, 10.0)]).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    lay = jt.ConeLayout([jt.rpos(m + 2 * n)])
    monkeypatch.setattr(tconic, "_on_card", lambda a_op: True)
    ct, at, bt, tl = _t(c, a, b, lay, dtype=torch.float32)
    p = tt.SolverParam(max_iter=60000, eps_acc=1e-3, check_period=10,
                       kernel="auto", log_period=50000)
    with pytest.warns(RuntimeWarning, match="megakernel"):
        r = tt.solve_jit(ct, at, bt, tl, p)
    assert r.status == SolverStatus.CONVERGED  # the host loop took over
    op = tt.DenseOp(at)
    rp = tconic._resolve_fast_profile(
        tt.SolverParam(profile="fast", log_period=1000), op, tl)
    assert rp.method == "direct"
    rp0 = tconic._resolve_fast_profile(tt.SolverParam(profile="fast"), op, tl)
    assert rp0.method == "pdhg" and rp0.kernel == "auto"


def test_mega_forced_with_logging_prints_nothing(capfd):
    c, g, h, lay = _boxed_lp(n=8, seed=1)
    ct, gt, ht, tl = _t(*(np.asarray(x, np.float32) for x in (c, g, h)),
                        lay, dtype=torch.float32)
    r = tt.solve_jit(ct, gt, ht, tl, tt.SolverParam(
        max_iter=200, check_period=10, kernel="mega", log_period=10))
    assert r.iters == 200
    assert _lines(capfd.readouterr().out) == []


# ---- the Solver facade and set_par_by_env


def test_solver_facade_par():
    prob = tt.problems.qp(np.eye(2), [1.0, 2.0], g=[[-0.5, -1.0 / 3.0]],
                          h=[-1.0], device="cpu")
    s = tt.Solver().par(lambda p: setattr(p, "max_iter", 100_000))
    res = s.solve(prob)
    assert s.param.max_iter == 100_000
    np.testing.assert_allclose(res.x.numpy()[:2], [2.0, 0.0], atol=1e-3)
    pj = jt.problems.qp(np.eye(2), [1.0, 2.0], g=[[-0.5, -1.0 / 3.0]],
                        h=[-1.0])
    rj = jt.Solver().par(lambda p: setattr(p, "max_iter", 100_000)).solve(pj)
    assert res.iters == int(rj.iters)
    _x_close(res, rj)


def test_solver_facade_tuple_and_device():
    c, a, b, lay = _golden()
    s = tt.Solver(tt.SolverParam(max_iter=100_000))
    res = s.solve((c, a, b, interop.cone_from_reference(lay)), device="cpu")
    assert res.iters == 160 and res.x.device.type == "cpu"
    with pytest.raises(SolverError):
        tt.Solver().par(lambda p: setattr(p, "max_iter", 10)).solve(
            (c, a, b, interop.cone_from_reference(lay)), device="cpu")


def test_set_par_by_env(monkeypatch):
    from totsu_tpu.utils import set_par_by_env as jset
    from totsu_tpu_torch.utils import set_par_by_env
    env = {"MAX_ITER": "1234", "EPS_ACC": "1e-4", "CHECK_PERIOD": "7",
           "PROFILE": "fast", "ACCEL": "halpern", "LOG_PERIOD": "50",
           "EPS_INF": "1e-5", "EPS_ZERO": "1e-11", "EQUIL_ITERS": "3",
           "RELAX": "1.5", "METHOD": "direct", "KERNEL": "mega"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p = set_par_by_env(tt.SolverParam())
    assert p.max_iter == 1234 and p.eps_acc == 1e-4
    assert p.check_period == 7 and p.profile == "fast"
    assert p.accel == "halpern" and p.log_period == 50
    assert interop.param_from_reference(jset(jt.SolverParam())) == p
    for k in env:
        monkeypatch.delenv(k)
    assert set_par_by_env(tt.SolverParam()) == tt.SolverParam()
