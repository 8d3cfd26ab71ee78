"""The indirect engine of the port against the JAX package's.

``method='direct'`` on any operator that is not a dense A runs
Douglas-Rachford on the embedding with each (I + Q) solve by
warm-started, optionally Jacobi-preconditioned CG on I + A^T A
(``solver/direct.py`` ``_cg``, ``IndirectSolve``). The problems are made
once with numpy and handed to both packages. In f64 the port's host loops
follow the JAX ``lax.while_loop``s term by term: ``_cg`` takes the same
steps to x and rel2 within 1e-10, and a solve ends with the same status
and iteration count, x and y within 1e-8. A checkpoint carries the CG
warm start, so split and chunked solves are exact, also across the two
packages.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.solver import direct as jdirect
from totsu_tpu_torch import interop
from totsu_tpu_torch.solver import direct as tdirect

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its problems are small, and
    the suite runs several workers on one machine, where torch's thread
    pools would oversubscribe the cores (measured: the module ran ten
    times slower beside five busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _banded_box_lp(n=48, bw=6, seed=7):
    """tests/test_direct.py's bounded LP with blocked-ELL-friendly
    structure: banded rows plus a two-sided box."""
    rng = np.random.default_rng(seed)
    band = np.zeros((n, n))
    for i in range(n):
        lo, hi2 = max(0, i - bw), min(n, i + bw)
        band[i, lo:hi2] = rng.normal(size=hi2 - lo)
    a = np.concatenate([band, np.eye(n), -np.eye(n)])
    h = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 5.0)])
    c = rng.normal(size=n)
    return c, a, h, jt.ConeLayout([jt.rpos(3 * n)])


def _ops(kind, a):
    """The same operator in both packages: a BlockedEllOp (16 x 16
    tiles) or a matrix-free CustomOp whose adjoint each package derives
    (autograd in the port, jax.linear_transpose in JAX)."""
    m, n = a.shape
    if kind == "ell":
        return (tt.BlockedEllOp.from_dense(a, block=(16, 16), device=CPU),
                jt.BlockedEllOp.from_dense(a, block=(16, 16)))
    return (tt.CustomOp(params=_t(a), m=m, n=n, matvec_fn=lambda p, x: p @ x),
            jt.CustomOp(params=jnp.asarray(a), m=m, n=n,
                        matvec_fn=lambda p, x: p @ x))


def _assert_same_solve(rt, rj, atol=1e-8):
    assert rt.status == int(rj.status)
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), rtol=0,
                               atol=atol)


# ---- _cg, step for step


def _jax_cg(apply_fn, rhs, x0, rel_tol, max_cg, inv_diag):
    """JAX's _cg run eagerly (``jax.disable_jit``: the while_loop runs as
    a Python loop), its steps counted by the calls of ``apply_fn`` (one
    for the initial residual, one per step)."""
    calls = []

    def counted(z):
        calls.append(1)
        return apply_fn(z)

    with jax.disable_jit():
        x, rel2 = jdirect._cg(counted, rhs, x0, rel_tol, max_cg, inv_diag)
    return np.asarray(x), float(rel2), len(calls) - 1


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("max_cg", [500, 3], ids=["to_tol", "truncated"])
def test_cg_matches_jax_step_for_step(precond, warm, max_cg):
    _, a, _, _ = _banded_box_lp(seed=3)
    # columns scaled over 4x (Jacobi takes fewer steps); with this
    # right-hand side every stop, and the step before it, lies 2x or more
    # from the tolerance, so the two packages' roundoff cannot flip one
    a = 0.3 * a * np.random.default_rng(4).uniform(0.5, 2.0, size=(1, 48))
    rng = np.random.default_rng(15)
    rhs = rng.normal(size=48)
    x0 = rng.normal(size=48) * 0.1 if warm else np.zeros(48)
    inv_diag = 1.0 / (1.0 + (a * a).sum(axis=0)) if precond else None
    aj, at = jnp.asarray(a), _t(a)
    xj, relj, stepsj = _jax_cg(
        lambda z: z + aj.T @ (aj @ z), jnp.asarray(rhs), jnp.asarray(x0),
        1e-8, max_cg, None if inv_diag is None else jnp.asarray(inv_diag))
    xt, relt, stepst = tdirect._cg(
        lambda z: z + at.T @ (at @ z), _t(rhs), _t(x0), 1e-8, max_cg,
        None if inv_diag is None else _t(inv_diag))
    assert stepst == stepsj > 0
    assert (relj > 1e-16) == (max_cg == 3)     # only the cap of 3 truncates
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-10)
    # rel2 to 1e-10; a truncated solve's (about 1e-3) to 1e-8 relative.
    # At the tolerance the residual is roundoff-sized, so the two sums
    # orders differ there by percents of its 1e-17
    np.testing.assert_allclose(float(relt), relj, atol=1e-10,
                               rtol=1e-8 if max_cg == 3 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("eps_acc", [1e-3, 1e-9])
def test_cg_tolerances_are_the_jax_package_s(dtype, eps_acc):
    # cg_tol = max(min(eps_acc 1e-2, 1e-8), 30 eps), max_cg = min(n, 500)
    # (a fixed cap, mirrored from the JAX package), the border's solve
    # tighter: max(cg_tol 1e-2, 4 eps) in min(4n, 4000) steps
    eps = float(torch.finfo(dtype).eps)
    for n in (48, 4096):
        op = tt.DiagOp(torch.ones(n, dtype=dtype))
        s = tdirect.IndirectSolve(op, n, dtype, torch.device(CPU),
                                  tt.SolverParam(eps_acc=eps_acc))
        assert s.cg_tol == max(min(eps_acc * 1e-2, 1e-8), 30.0 * eps)
        assert s.max_cg == min(n, 500)
        assert s.setup_tol == max(s.cg_tol * 1e-2, 4.0 * eps)
        assert s.setup_max == min(4 * n, 4000)
    with pytest.raises(ValueError, match="cg_precond"):
        tdirect.IndirectSolve(op, n, dtype, torch.device(CPU),
                              tt.SolverParam(cg_precond="ilu"))


# ---- the engine in f64: status, iterations, x and y


ENGINE = [("ell", "", "jacobi", None), ("ell", "halpern", "jacobi", None),
          ("ell", "halpern", "none", None), ("ell", "halpern", "auto", 10),
          ("ell", "", "auto", 10), ("custom", "", "auto", None),
          ("custom", "halpern", "auto", None)]


@pytest.mark.parametrize(
    "kind,accel,precond,equil", ENGINE,
    ids=[f"{k}-{a or 'plain'}-{p}-equil{e or 0}" for k, a, p, e in ENGINE])
def test_indirect_engine_matches_jax_f64(kind, accel, precond, equil):
    # Halpern converges here in about 1,300-1,500 DR iterations; plain DR
    # needs several thousand, so it is held over its first 2,000
    c, a, h, lay = _banded_box_lp()
    op_t, op_j = _ops(kind, a)
    kw = dict(max_iter=2_000, method="direct", check_period=10,
              accel=accel, eps_acc=1e-5, cg_precond=precond,
              equil_iters=equil)
    rj = jt.solve_jit(jnp.asarray(c), op_j, jnp.asarray(h), lay,
                      jt.SolverParam(**kw))
    rt = tt.solve_jit(_t(c), op_t, _t(h), interop.cone_from_reference(lay),
                      tt.SolverParam(**kw))
    if accel == "halpern":
        assert rt.status == tt.SolverStatus.CONVERGED
    _assert_same_solve(rt, rj)
    # the same CG health: the worst relative resolvent residual, the target
    np.testing.assert_allclose(float(rt.diag["cg_worst_rel"]),
                               float(rj.diag["cg_worst_rel"]), rtol=1e-6)
    assert float(rt.diag["cg_tol"]) == float(rj.diag["cg_tol"])
    assert rt.diag["cg_steps"] > rt.diag["cg_solves"] >= rt.iters


# ---- checkpoints: the CG warm start rides along


def _solve_t(c, op, h, lay, **kw):
    return tt.solve_jit(_t(c), op, _t(h), interop.cone_from_reference(lay),
                        tt.SolverParam(**kw))


@pytest.mark.parametrize("accel", ["", "halpern"])
def test_indirect_split_and_chunks_are_exact(accel, monkeypatch):
    # k iterations, then k more from the checkpoint, against one solve of
    # 2k: bitwise; the resumed call skips the border's CG solve (the
    # checkpoint carries it) and starts CG from the carried warm start
    c, a, h, lay = _banded_box_lp()
    op, _ = _ops("ell", a)
    kw = dict(method="direct", check_period=10, accel=accel, eps_acc=1e-5,
              return_state=True)
    whole = _solve_t(c, op, h, lay, max_iter=200, **kw)
    first = _solve_t(c, op, h, lay, max_iter=100, **kw)
    assert set(first.state.aux) >= {"gh", "denom", "ws"}
    z1, worst = first.state.aux["ws"]
    assert z1.shape == (48,) and worst.dim() == 0

    def no_setup(*args):
        raise AssertionError("the border's CG solve ran again")

    with monkeypatch.context() as mp:
        mp.setattr(tdirect.IndirectSolve, "setup_solve", no_setup)
        second = tt.solve_jit(_t(c), op, _t(h),
                              interop.cone_from_reference(lay),
                              tt.SolverParam(max_iter=100, **kw),
                              resume_state=first.state)
    assert second.state.k == whole.state.k == 200
    assert second.status == whole.status == tt.SolverStatus.EXCESS_ITER
    for f in ("x", "y", "cri_pri", "cri_dual", "cri_gap"):
        assert torch.equal(getattr(second, f), getattr(whole, f)), f
    assert torch.equal(second.state.aux["ws"][0], whole.state.aux["ws"][0])
    # a chunked solve takes the whole solve's iterations to the same x
    p = tt.SolverParam(max_iter=100_000, method="direct", check_period=10,
                       accel=accel, eps_acc=1e-4)
    full = tt.solve(_t(c), op, _t(h), interop.cone_from_reference(lay), p)
    chunked = tt.solve(_t(c), op, _t(h), interop.cone_from_reference(lay), p,
                       chunk_iters=150)
    assert chunked.iters == full.iters > 150
    assert torch.equal(chunked.x, full.x)


@pytest.mark.parametrize("accel", ["", "halpern"])
def test_jax_indirect_checkpoint_resumes_in_the_port(accel):
    # a JAX indirect-engine checkpoint, its CG warm start included,
    # continues in the port on JAX's path: the same iterations, x to 1e-8
    c, a, h, lay = _banded_box_lp()
    op_t, op_j = _ops("ell", a)
    kw = dict(method="direct", check_period=10, accel=accel, eps_acc=1e-5)
    pj1 = jt.solve_jit(jnp.asarray(c), op_j, jnp.asarray(h), lay,
                       jt.SolverParam(max_iter=60, return_state=True, **kw))
    pj2 = jt.solve_jit(jnp.asarray(c), op_j, jnp.asarray(h), lay,
                       jt.SolverParam(max_iter=1_500, **kw),
                       resume_state=pj1.state)
    state = interop.resume_state_from_reference(pj1.state, device=CPU)
    assert state.k == 60 and set(state.aux) == set(pj1.state.aux)
    for ours, theirs in zip(state.aux["ws"], pj1.state.aux["ws"]):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    rt = tt.solve_jit(_t(c), op_t, _t(h), interop.cone_from_reference(lay),
                      tt.SolverParam(max_iter=1_500, **kw),
                      resume_state=state)
    _assert_same_solve(rt, pj2)


def test_indirect_checkpoint_aux_keys_match_jax():
    c, a, h, lay = _banded_box_lp()
    op_t, op_j = _ops("ell", a)
    for accel in ("", "halpern"):
        kw = dict(max_iter=40, method="direct", check_period=20,
                  accel=accel, return_state=True)
        rt = _solve_t(c, op_t, h, lay, **kw)
        rj = jt.solve_jit(jnp.asarray(c), op_j, jnp.asarray(h), lay,
                          jt.SolverParam(**kw))
        assert set(rt.state.aux) == set(rj.state.aux), accel


def test_resume_state_is_checked_for_the_ws_dtype():
    # the carried warm start is a tensor of the checkpoint like the others:
    # another dtype raises instead of being cast
    c, a, h, lay = _banded_box_lp()
    op, _ = _ops("ell", a)
    kw = dict(method="direct", check_period=10, accel="halpern")
    part = _solve_t(c, op, h, lay, max_iter=20, return_state=True, **kw)
    z1, worst = part.state.aux["ws"]
    bad = dataclasses.replace(part.state, aux={
        **part.state.aux, "ws": (z1.float(), worst)})
    with pytest.raises(ValueError, match="resume_state holds"):
        tt.solve_jit(_t(c), op, _t(h), interop.cone_from_reference(lay),
                     tt.SolverParam(max_iter=20, **kw), resume_state=bad)
