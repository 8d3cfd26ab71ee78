"""The port's ``kernel='mega'`` path against the JAX megakernel.

On the CPU the port's megakernel wrapper runs its plain version, which is
the port's own host loop on the same inputs; the JAX side runs the Pallas
kernel in interpret mode (``kernel='mega'`` off the TPU), as
``tests/test_megakernel.py`` does. Both are f32, so they agree on the
status and the iteration count, and on x to f32 reduction-order roundoff
(atol 1e-4). The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.ops.kernels import megakernel as mk


def _lp(n=24, m=60, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, n))
    x0 = rng.normal(size=n)
    h = g @ x0 + rng.random(m) + 0.1
    eye = np.eye(n)
    a = np.concatenate([g, eye, -eye], axis=0).astype(np.float32)
    b = np.concatenate([h, np.full(n, 10.0), np.full(n, 10.0)]).astype(
        np.float32)
    c = rng.normal(size=n).astype(np.float32)
    return c, a, b, jt.ConeLayout([jt.rpos(m + 2 * n)])


def _soc_zero():
    rng = np.random.default_rng(5)
    n = 20
    lay = jt.ConeLayout([jt.soc(3, count=6), jt.soc(1), jt.rpos(12),
                         jt.zero(4)])
    a = rng.normal(size=(lay.dim, n)).astype(np.float32)
    b = (a @ rng.normal(size=n)).astype(np.float32)
    b[19:31] += rng.random(12).astype(np.float32) + 0.1
    b[:19] += 0.5
    c = rng.normal(size=n).astype(np.float32)
    return c, a, b, lay


def _rsoc():
    rng = np.random.default_rng(11)
    n = 18
    lay = jt.ConeLayout([jt.rsoc(4, count=5), jt.rsoc(1), jt.rpos(10),
                         jt.zero(3)])
    a = rng.normal(size=(lay.dim, n)).astype(np.float32)
    b = (a @ rng.normal(size=n)).astype(np.float32)
    b[:20] += 2.0
    b[21:31] += rng.random(10).astype(np.float32) + 0.1
    c = rng.normal(size=n).astype(np.float32)
    return c, a, b, lay


def _qp():
    # the qp() reduction: epigraph + RSOC + R+, built by the JAX package
    # in f64 and cast to f32 (the kernel is f32)
    from totsu_tpu.problems import qp
    rng = np.random.default_rng(7)
    n, mi = 8, 6
    q0 = rng.normal(size=(n, n))
    p = q0 @ q0.T + n * np.eye(n)
    q = rng.normal(size=n)
    g = rng.normal(size=(mi, n))
    h = g @ rng.normal(size=n) + 1.0 + rng.random(mi)
    prob = qp(p, q, g, h)
    return (np.asarray(prob.c, np.float32), np.asarray(prob.a.a, np.float32),
            np.asarray(prob.b, np.float32), prob.cone)


def _infeasible():
    c = np.array([1.0], np.float32)
    a = np.array([[1.0], [-1.0]], np.float32)
    b = np.array([-1.0, -1.0], np.float32)
    return c, a, b, jt.ConeLayout([jt.rpos(2)])


CASES = {
    "plain": (_lp, dict(eps_acc=1e-3), jt.SolverStatus.CONVERGED),
    "halpern_normalize_equil": (
        lambda: _lp(seed=1),
        dict(eps_acc=1e-3, accel="halpern", normalize=True, equil_iters=10),
        jt.SolverStatus.CONVERGED),
    "soc_zero": (_soc_zero, dict(eps_acc=1e-3), None),
    "rsoc": (_rsoc, dict(eps_acc=1e-3), None),
    "qp_reduction": (_qp, dict(eps_acc=1e-4), jt.SolverStatus.CONVERGED),
    "infeasible": (_infeasible, dict(eps_acc=1e-6),
                   jt.SolverStatus.INFEASIBLE),
}


@pytest.mark.parametrize("name", list(CASES))
def test_mega_matches_jax_mega(name):
    make, kw, want = CASES[name]
    c, a, b, lay = make()
    pj = jt.SolverParam(max_iter=60_000, check_period=10, kernel="mega", **kw)
    rj = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay,
                      pj)
    ct, at, bt = interop.problem_from_numpy(c, a, b, dtype=torch.float32)
    rt = tt.solve_jit(ct, at, bt, interop.cone_from_reference(lay),
                      interop.param_from_reference(pj))
    if want is not None:
        assert int(rj.status) == want
    assert rt.status == int(rj.status)
    assert rt.iters == int(rj.iters)
    if rt.converged:
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-4)


def test_mega_plain_version_is_the_host_loop(monkeypatch):
    # on the CPU kernel='mega' runs the plain version, which is the host
    # loop itself: it gives the kernel='' result bit for bit
    c, a, b, lay = _rsoc()
    ct, at, bt = interop.problem_from_numpy(c, a, b, dtype=torch.float32)
    tl = interop.cone_from_reference(lay)
    kw = dict(max_iter=60_000, check_period=10, eps_acc=1e-3,
              accel="halpern")
    calls = []
    real = mk.solve_mega_plain
    monkeypatch.setattr(mk, "solve_mega_plain",
                        lambda *a_, **k_: calls.append(1) or real(*a_, **k_))
    before = mk.launches
    rm = tt.solve_jit(ct, at, bt, tl, tt.SolverParam(kernel="mega", **kw))
    rx = tt.solve_jit(ct, at, bt, tl, tt.SolverParam(**kw))
    assert calls == [1] and mk.launches == before
    assert rm.status == rx.status and rm.iters == rx.iters
    assert torch.equal(rm.x, rx.x)


def test_mega_auto_keeps_host_loop_on_cpu(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("kernel='auto' took the megakernel on the CPU")
    monkeypatch.setattr(mk, "solve_mega", boom)
    c, a, b, lay = _lp(seed=3)
    ct, at, bt = interop.problem_from_numpy(c, a, b, dtype=torch.float32)
    r = tt.solve_jit(ct, at, bt, interop.cone_from_reference(lay),
                     tt.SolverParam(max_iter=60_000, eps_acc=1e-3,
                                    check_period=10, kernel="auto"))
    assert r.converged


def test_mega_envelope_rejections():
    c, a, b, lay = _lp()
    tl = interop.cone_from_reference(lay)
    # f64 data: the kernel is f32
    ct, at, bt = interop.problem_from_numpy(c, a, b)
    with pytest.raises(ValueError, match="mega"):
        tt.solve_jit(ct, at, bt, tl, tt.SolverParam(max_iter=10,
                                                    kernel="mega"))
    # exp / pow / PSD layouts have no in-kernel projection yet
    for f in (tt.expc(2), tt.powc(0.5), tt.psd(2)):
        assert not mk.supported(tt.ConeLayout([f]))
    assert mk.supported(tt.ConeLayout([tt.soc(3), tt.rsoc(1), tt.zero(2),
                                       tt.rpos(1)]))
    # the envelope is A resident in the card's L2 (24 MiB of f32)
    assert mk.fits(4000, 1000, tl)
    assert not mk.fits(8000, 2000, tl)


def test_cone_tables():
    lay = tt.ConeLayout([tt.zero(2), tt.soc(3, 2), tt.rsoc(1, 2),
                         tt.rsoc(4), tt.rpos(1)])
    kind, blocks = mk.cone_tables(lay)
    assert kind.tolist() == [0, 0, 2, 2, 2, 2, 2, 2, 1, 1, 2, 2, 2, 2, 1]
    assert blocks.tolist() == [[2, 3, 0], [5, 3, 0], [10, 4, 1]]
