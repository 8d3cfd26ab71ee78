"""The port's ``kernel='mega'`` path against the JAX megakernel.

On the CPU the port's megakernel wrapper runs its plain version, which is
the port's own host loop on the same inputs; the JAX side runs the Pallas
kernel in interpret mode (``kernel='mega'`` off the TPU), as
``tests/test_megakernel.py`` does, or, for the exp and pow cases, the JAX
host engine (``kernel=''``), which that file holds equal to the Pallas
kernel. Both are f32, so they agree on the
status and the iteration count, and on x to f32 reduction-order roundoff
(atol 1e-4). The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.
"""

import dataclasses

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
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=torch.float32)
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
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=torch.float32)
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
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=torch.float32)
    r = tt.solve_jit(ct, at, bt, interop.cone_from_reference(lay),
                     tt.SolverParam(max_iter=60_000, eps_acc=1e-3,
                                    check_period=10, kernel="auto"))
    assert r.converged


def test_mega_envelope_rejections():
    c, a, b, lay = _lp()
    tl = interop.cone_from_reference(lay)
    # f64 data: the kernel is f32
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu")
    with pytest.raises(ValueError, match="mega"):
        tt.solve_jit(ct, at, bt, tl, tt.SolverParam(max_iter=10,
                                                    kernel="mega"))
    # PSD layouts have no in-kernel projection; exp and pow have
    assert not mk.supported(tt.ConeLayout([tt.psd(2)]))
    assert not mk.supported(tt.ConeLayout([tt.expc(2), tt.psd(2)]))
    for f in (tt.expc(2), tt.powc(0.5)):
        assert mk.supported(tt.ConeLayout([f]))
    assert mk.supported(tt.ConeLayout([tt.soc(3), tt.rsoc(1), tt.zero(2),
                                       tt.rpos(1), tt.expc(1),
                                       tt.powc(0.3, 2)]))
    # the envelope is A resident in the card's L2 (24 MiB of f32)
    assert mk.fits(4000, 1000, tl)
    assert not mk.fits(8000, 2000, tl)


def test_cone_tables():
    lay = tt.ConeLayout([tt.zero(2), tt.soc(3, 2), tt.rsoc(1, 2),
                         tt.rsoc(4), tt.rpos(1)])
    kind, blocks, tri, tri_alpha = mk.cone_tables(lay)
    assert kind.tolist() == [0, 0, 2, 2, 2, 2, 2, 2, 1, 1, 2, 2, 2, 2, 1]
    assert blocks.tolist() == [[2, 3, 0], [5, 3, 0], [10, 4, 1]]
    assert tri.shape == (0, 2) and tri_alpha.shape == (0,)


def test_cone_tables_exp_pow():
    # exp and pow elements get their own kinds (the elementwise loop skips
    # them) and a row each in the 3-block table, with the pow exponent
    lay = tt.ConeLayout([tt.rpos(1), tt.expc(2), tt.soc(3), tt.powc(0.3),
                         tt.zero(1), tt.powc(0.9, 2)])
    kind, blocks, tri, tri_alpha = mk.cone_tables(lay)
    assert kind.tolist() == ([1] + [3] * 6 + [2] * 3 + [4] * 3 + [0]
                             + [4] * 6)
    assert blocks.tolist() == [[7, 3, 0]]
    assert tri.tolist() == [[1, 0], [4, 0], [10, 1], [14, 1], [17, 1]]
    assert tri_alpha.dtype == np.float32
    np.testing.assert_array_equal(
        tri_alpha, np.float32([0.0, 0.0, 0.3, 0.9, 0.9]))


def _cone_mix_lp(factors, interior, n=6, seed=0):
    """tests/test_megakernel.py's feasible, bounded f32 instance with the
    given leading cone factors (JAX layout)."""
    rng = np.random.default_rng(seed)
    lay = jt.ConeLayout(list(factors) + [jt.rpos(2 * n)])
    m = lay.dim
    a = np.concatenate([rng.normal(size=(m - 2 * n, n)) / np.sqrt(n),
                        np.eye(n), -np.eye(n)])
    s0 = np.concatenate([np.tile(pt, f.count)
                         for f, pt in zip(factors, interior)]
                        + [np.ones(2 * n)])
    b = a @ (rng.normal(size=n) * 0.5) + s0
    c = rng.normal(size=n)
    return (c.astype(np.float32), a.astype(np.float32),
            b.astype(np.float32), lay)


_EXP_PT = np.array([0.0, 1.0, 2.0])
_POW_PT = np.array([2.0, 2.0, 1.0])

# the cases of tests/test_megakernel.py (exp, pow, exp+pow under Halpern,
# soc+exp), all f32 with eps_acc 1e-4 and check_period 20
EXP_POW_CASES = {
    "exp": (lambda: _cone_mix_lp([jt.expc(count=3), jt.rpos(2)],
                                 [_EXP_PT, np.ones(2)]), ""),
    "pow": (lambda: _cone_mix_lp([jt.powc(0.3, count=2), jt.rpos(2)],
                                 [_POW_PT, np.ones(2)]), ""),
    "exp_pow_halpern": (lambda: _cone_mix_lp(
        [jt.expc(count=2), jt.powc(0.7), jt.rpos(1)],
        [_EXP_PT, _POW_PT, np.ones(1)]), "halpern"),
    "soc_exp_halpern": (lambda: _cone_mix_lp(
        [jt.soc(4, count=2), jt.expc(count=2), jt.rpos(3)],
        [np.array([2.0, 0.3, 0.3, 0.3]), _EXP_PT, np.ones(3)], seed=2),
        "halpern"),
}


def _mega_pair(c, a, b, lay, jax_kernel, **kw):
    """(JAX result, port result) of one f32 solve: JAX with
    ``kernel=jax_kernel``, the port with kernel='mega' (its plain version
    on the CPU)."""
    pj = jt.SolverParam(kernel=jax_kernel, **kw)
    rj = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay,
                      pj)
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=torch.float32)
    pt = dataclasses.replace(interop.param_from_reference(pj), kernel="mega")
    rt = tt.solve_jit(ct, at, bt, interop.cone_from_reference(lay), pt)
    return rj, rt


@pytest.mark.parametrize("name", list(EXP_POW_CASES))
def test_mega_exp_pow_matches_jax(name):
    # held against JAX's host engine (kernel=''), which its own tests hold
    # equal to its interpret-mode megakernel in status and iteration count
    # and to 5e-6 in x; f32 sums in other orders: x to 1e-4
    make, accel = EXP_POW_CASES[name]
    c, a, b, lay = make()
    rj, rt = _mega_pair(c, a, b, lay, "", max_iter=200_000, eps_acc=1e-4,
                        check_period=20, accel=accel)
    assert int(rj.status) == tt.SolverStatus.CONVERGED
    assert rt.status == int(rj.status)
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-4)


def test_mega_exp_matches_jax_interpret_megakernel():
    # the one case run against the JAX Pallas megakernel itself
    # (interpret mode on the CPU)
    c, a, b, lay = EXP_POW_CASES["exp"][0]()
    rj, rt = _mega_pair(c, a, b, lay, "mega", max_iter=200_000,
                        eps_acc=1e-4, check_period=20)
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-4)


def test_mega_exp_warm_start_converges_immediately():
    # check_at_start with the exp projection: re-solving from the solution
    # stops at 0 iterations, as in JAX
    c, a, b, lay = _cone_mix_lp([jt.expc(count=2), jt.rpos(2)],
                                [_EXP_PT, np.ones(2)], seed=3)
    ct, at, bt = interop.problem_from_numpy(c, a, b, device="cpu",
                                            dtype=torch.float32)
    tl = interop.cone_from_reference(lay)
    p = tt.SolverParam(kernel="mega", max_iter=200_000, eps_acc=1e-4,
                       check_period=20)
    r1 = tt.solve_jit(ct, at, bt, tl, p)
    assert r1.converged
    r2 = tt.solve_jit(ct, at, bt, tl, p, warm_start=(r1.x, r1.y))
    assert r2.converged and r2.iters == 0
    rj1 = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay,
                       jt.SolverParam(max_iter=200_000, eps_acc=1e-4,
                                      check_period=20))
    assert r1.iters == int(rj1.iters)


def test_mega_args_mirror_the_c_struct():
    # _MegaArgs must list MegaArgs' fields in order with matching types:
    # totsu_mega_struct_size checks only the size on the card, which a
    # swap of two pointers would keep
    import ctypes
    import re
    from totsu_tpu_torch.ops.kernels import _build
    src = (_build.CSRC / "megakernel.cu").read_text()
    body = re.search(r"struct MegaArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, names = re.match(r"((?:const )?\w+\*?)\s+(.*)", decl,
                                re.S).groups()
        kind = ("ptr" if ctype.endswith("*") else
                {"int": "int", "float": "float"}[ctype])
        fields += [(name.strip(), kind) for name in names.split(",")]
    py = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
          ctypes.c_float: "float"}
    assert [(name, py[t]) for name, t in mk._MegaArgs._fields_] == fields
