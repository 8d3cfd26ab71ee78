"""The fast profile's routing and ``accel='restart'`` of the PyTorch port
against the JAX package.

``_resolve_fast_profile`` is held field for field to the JAX one over a
grid of dense layouts, sizes and parameter sets, with the device test
forced both ways (the JAX package asks whether it runs on a TPU, the
port whether A lies on a CUDA device). The restarted-averaging pdhg loop
follows the JAX ``lax.while_loop`` term by term: in f64 the same
iteration count and x to roundoff. The rest twins the fast-profile and
restart tests of ``tests/test_solver.py``.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.solver import conic as jconic
from totsu_tpu_torch import interop
from totsu_tpu_torch.solver import conic as tconic

LAYOUTS = {
    "rpos": lambda m: [jt.rpos(6)],
    "rsoc": lambda m: [jt.rsoc(4), jt.rpos(2)],
    "soc": lambda m: [jt.soc(3, count=2)],
    "exp": lambda m: [jt.expc(count=2), jt.rpos(3)],
    "pow": lambda m: [jt.powc(0.4, count=2), jt.rpos(3)],
}

PARAMS = {
    "default": {},
    "pdhg_relax": dict(method="pdhg", relax=1.9),
    "restart_cp5": dict(accel="restart", check_period=5),
    "kernel_empty": dict(kernel=""),
    "bf16_matvec": dict(matvec_dtype="bfloat16"),
    "log_period": dict(log_period=10),
    "equil_3": dict(equil_iters=3),
    "equil_0": dict(equil_iters=0),
}


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "host"])
@pytest.mark.parametrize("n", [50, 250, 350, 9000])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_resolve_fast_profile_matches_jax(layout, n, on_card, monkeypatch):
    monkeypatch.setattr(jconic, "_exec_platform",
                        lambda: "tpu" if on_card else "cpu")
    monkeypatch.setattr(tconic, "_on_card", lambda a_op: on_card)
    lay = jt.ConeLayout(LAYOUTS[layout](None))
    cone = interop.cone_from_reference(lay)
    a_j = jnp.zeros((lay.dim, n), jnp.float32)
    a_t = tt.DenseOp(torch.zeros((lay.dim, n), dtype=torch.float32))
    for name, kw in PARAMS.items():
        for sharding in (None, object()):
            pj = jt.SolverParam(profile="fast", **kw)
            want = jconic._resolve_fast_profile(pj, a_j, lay, sharding)
            got = tconic._resolve_fast_profile(
                interop.param_from_reference(pj), a_t, cone, sharding)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                interop.param_from_reference(want)), (name, sharding)


def test_on_card_reads_the_device_of_a():
    assert not tconic._on_card(tt.DenseOp(torch.zeros(2, 2)))
    assert not tconic._on_card(tt.LinOp())


def _random_lp(n=60, seed=3):
    # tests/test_solver.py's _random_lp
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    return rng.normal(size=n), g, h, 2 * n


def _random_box_lp(n=60, seed=3):
    # tests/test_solver.py's _random_box_lp: _random_lp with |x| <= 10
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    eye = np.eye(n)
    g = np.concatenate([g, eye, -eye])
    h = np.concatenate([h, np.full(2 * n, 10.0)])
    return rng.normal(size=n), g, h, 4 * n


def _both(c, a, b, m, pj, warm=None):
    rj = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                      jt.ConeLayout([jt.rpos(m)]), pj, warm_start=warm)
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu")
    warm_t = None if warm is None else tuple(
        torch.from_numpy(np.array(w)) for w in warm)
    rt = tt.solve_jit(ct, at, bt, tt.ConeLayout([tt.rpos(m)]),
                      interop.param_from_reference(pj), warm_start=warm_t)
    return rj, rt


@pytest.mark.parametrize("kw", [
    {}, dict(normalize=True, equil_iters=10)],
    ids=["plain", "normalize_equil"])
def test_accel_restart_matches_jax(kw):
    # f64: the same iteration count and x to roundoff; the optimum of the
    # plain loop (tests/test_solver.py test_accel_restart_converges_
    # matching_plain; the plain side runs in the JAX package)
    c, a, b, m = _random_lp(seed=4)
    pj = jt.SolverParam(eps_acc=1e-5, check_period=20, max_iter=2_000_000,
                        accel="restart", **kw)
    rj, rt = _both(c, a, b, m, pj)
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), rtol=0,
                               atol=1e-8)
    plain = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                         jt.ConeLayout([jt.rpos(m)]),
                         jt.SolverParam(eps_acc=1e-5, check_period=20,
                                        max_iter=2_000_000))
    np.testing.assert_allclose(float(c @ rt.x.numpy()),
                               float(c @ np.asarray(plain.x)), rtol=1e-3,
                               atol=1e-3)


def test_accel_restart_f32_matches_jax():
    # f32: the sums run in other orders; iterations within two check
    # periods (seen: equal), x within 1e-4
    c, a, b, m = _random_lp(seed=4)
    kw = dict(eps_acc=1e-3, check_period=20, max_iter=200_000,
              accel="restart")
    rj = jt.solve_jit(*(jnp.asarray(x, jnp.float32) for x in (c, a, b)),
                      jt.ConeLayout([jt.rpos(m)]), jt.SolverParam(**kw))
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=torch.float32)
    rt = tt.solve_jit(ct, at, bt, tt.ConeLayout([tt.rpos(m)]),
                      tt.SolverParam(**kw))
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert abs(rt.iters - int(rj.iters)) <= 40
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-4)


def test_accel_restart_mega_raises():
    c, a, b, m = _random_lp(n=8)
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=torch.float32)
    with pytest.raises(ValueError, match="accel"):
        tt.solve_jit(ct, at, bt, tt.ConeLayout([tt.rpos(m)]),
                     tt.SolverParam(accel="restart", kernel="mega"))


def test_fast_profile_lp():
    # tests/test_solver.py:322 on the port: the fast profile (the direct
    # engine on the CPU) reaches the reference profile's optimum in a
    # tenth of its iterations (the reference side runs in the JAX
    # package), and matches the JAX fast profile exactly
    c, a, b, m = _random_box_lp(seed=8)
    ref = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                       jt.ConeLayout([jt.rpos(m)]),
                       jt.SolverParam(eps_acc=1e-6, max_iter=2_000_000))
    pj = jt.SolverParam(eps_acc=1e-6, max_iter=2_000_000, profile="fast")
    rj, rt = _both(c, a, b, m, pj)
    assert rt.converged
    np.testing.assert_allclose(float(c @ rt.x.numpy()),
                               float(c @ np.asarray(ref.x)), rtol=1e-4,
                               atol=1e-4)
    assert rt.iters < int(ref.iters) // 10
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)


def test_fast_profile_respects_explicit_fields():
    # tests/test_solver.py:335 on the port
    a = tt.DenseOp(torch.zeros((6, 3)))
    lay = tt.ConeLayout([tt.rpos(6)])
    res = tconic._resolve_fast_profile
    p = res(tt.SolverParam(profile="fast"), a, lay)
    assert (p.method, p.accel, p.check_period, p.kernel) \
        == ("direct", "halpern", 20, "auto")
    p = res(tt.SolverParam(profile="fast", method="pdhg", relax=1.9), a, lay)
    assert p.method == "pdhg" and p.accel == "" and p.normalize is True \
        and p.equil_iters == 10
    p = res(tt.SolverParam(profile="fast", accel="restart", check_period=5),
            a, lay)
    assert p.accel == "restart" and p.check_period == 5
    p = res(tt.SolverParam(profile="fast", kernel=""), a, lay)
    assert p.kernel == "auto"
    p = res(tt.SolverParam(profile="fast", matvec_dtype="bfloat16"), a, lay)
    assert p.method == "pdhg" and p.normalize is True


def test_fast_profile_exp_pow_never_mega_first(monkeypatch):
    # tests/test_solver.py:516 on the port, with A on the card
    monkeypatch.setattr(tconic, "_on_card", lambda a_op: True)
    res = tconic._resolve_fast_profile
    lay = tt.ConeLayout([tt.expc(count=2), tt.rpos(6)])
    a = tt.DenseOp(torch.zeros((lay.dim, 4), dtype=torch.float32))
    assert res(tt.SolverParam(profile="fast"), a, lay).method == "direct"
    layp = tt.ConeLayout([tt.powc(0.4, count=2), tt.rpos(6)])
    assert res(tt.SolverParam(profile="fast"), a, layp).method == "direct"
    lays = tt.ConeLayout([tt.soc(4, count=3)])
    a2 = tt.DenseOp(torch.zeros((lays.dim, 4), dtype=torch.float32))
    p = res(tt.SolverParam(profile="fast"), a2, lays)
    assert p.method == "pdhg" and p.kernel == "auto"


def test_fast_profile_mega_first_stays_on_pdhg_auto(monkeypatch):
    # a small f32 LP resolved on the card stays on pdhg with kernel="auto"
    # (the megakernel on a CUDA tensor); on CPU tensors _mega_choice keeps
    # the host loop, so the solve is the host-loop Halpern pdhg of the
    # resolved parameters
    monkeypatch.setattr(tconic, "_on_card", lambda a_op: True)
    c, a, b, m = _random_box_lp(n=10, seed=1)
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=torch.float32)
    lay = tt.ConeLayout([tt.rpos(m)])
    p = tconic._resolve_fast_profile(tt.SolverParam(profile="fast"),
                                     tt.DenseOp(at), lay)
    assert (p.method, p.kernel, p.accel, p.normalize, p.equil_iters) == \
        ("pdhg", "auto", "halpern", True, 10)
    fast = tt.solve_jit(ct, at, bt, lay,
                        tt.SolverParam(profile="fast", eps_acc=1e-3))
    loop = tt.solve_jit(ct, at, bt, lay,
                        dataclasses.replace(p, eps_acc=1e-3))
    assert fast.converged and fast.iters == loop.iters
    assert torch.equal(fast.x, loop.x)


@pytest.mark.parametrize("kw,solve_kw", [
    (dict(method="direct", matvec_dtype="bfloat16"), {}),
    (dict(method="direct"), dict(row_sharding=object())),
], ids=["matvec_dtype", "row_sharding"])
def test_direct_rejects_pdhg_features(kw, solve_kw):
    # tests/test_solver.py:506 (and the row_sharding guard beside it)
    c, a, b = (torch.tensor(x, dtype=torch.float64) for x in
               ([-1.0, 0.0], [[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]],
                [6.0, 6.0, 1.0]))
    with pytest.raises(ValueError):
        tt.solve_jit(c, a, b, tt.ConeLayout([tt.rpos(3)]),
                     tt.SolverParam(**kw), **solve_kw)


def test_solve_sequence_through_the_fast_profile():
    # the second, unchanged problem starts at the first one's solution:
    # a fixed point of the direct engine, 0 iterations
    c, a, b, m = _random_box_lp(n=12, seed=5)
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu")
    cone = tt.ConeLayout([tt.rpos(m)])
    r1, r2 = tt.solve_sequence([(ct, at, bt, cone)] * 2,
                               tt.SolverParam(profile="fast", eps_acc=1e-6))
    assert r1.converged and r2.converged
    assert r1.iters > 0 and r2.iters == 0


@pytest.mark.parametrize("name", ["gp", "pow"])
def test_fast_profile_exp_pow_matches_jax(name):
    # the slice end to end: exp/pow layouts under profile='fast' take the
    # direct engine with Halpern in both packages; f64, the same iteration
    # count and x to roundoff
    import test_torch_direct as td
    c, a, b, lay = td.PROBLEMS[name]()
    pj = jt.SolverParam(profile="fast", eps_acc=1e-6, max_iter=100_000)
    assert jconic._resolve_fast_profile(pj, jnp.asarray(a), lay).method \
        == "direct"
    rj, rt = td._both(c, a, b, lay, pj)
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    td._assert_f64_parity(rj, rt)
