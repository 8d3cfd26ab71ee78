"""The port's batched megakernel (``solve_batch(kernel='mega')``) against
the JAX package's ``solve_batch`` with ``kernel='mega'``.

On the CPU the port's batched megakernel wrapper runs its plain version,
``megakernel.solve_mega_batch_plain``: the single solve's plain version
(the port's host loop) on each lane's inputs. The JAX side runs
``jax.vmap`` of its Pallas kernel in interpret mode, as
``tests/test_megakernel.py`` does for one solve, or, for exp and pow,
its host engine (``kernel=''``), as ``tests/test_torch_megakernel.py``
does. Both are f32: per lane the status and the iteration count are
equal and x agrees to f32 reduction-order roundoff (atol 1e-4). The CUDA
kernel itself is held against its single-lane solves and the host loop
on the card by ``chip_smoke.py`` (phase 36).
"""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.parallel.batch import solve_batch as jax_solve_batch
from totsu_tpu_torch import interop

from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

from test_torch_megakernel import _cone_mix_lp, _EXP_PT, _POW_PT, _lp, \
    _soc_zero


def _stack(problems):
    """(c (B, n), A (B, m, n), b (B, m)) f32 numpy, and the JAX layout."""
    return tuple(np.stack([p[j] for p in problems]) for j in range(3)) \
        + (problems[0][3],)


def _lp_lanes(seeds=(0, 1, 2)):
    return _stack([_lp(seed=s) for s in seeds])


def _lp_lanes_halpern():
    return _lp_lanes((0, 1, 2, 3))


def _shared_a(lanes=3):
    # one A for every lane (the port takes it expanded, not copied); c and
    # b differ per lane
    c, a, b, lay = _lp(seed=4)
    rng = np.random.default_rng(40)
    cs = np.stack([c * (1.0 + 0.2 * rng.random(c.shape[0]))
                   for _ in range(lanes)]).astype(np.float32)
    bs = np.stack([b + 0.1 * rng.random(b.shape[0])
                   for _ in range(lanes)]).astype(np.float32)
    return cs, np.broadcast_to(a, (lanes,) + a.shape), bs, lay


def _soc_lanes(lanes=3):
    c, a, b, lay = _soc_zero()
    rng = np.random.default_rng(50)
    bs = np.stack([b + 0.2 * rng.random(b.shape[0])
                   for _ in range(lanes)]).astype(np.float32)
    return (np.stack([c] * lanes), np.stack([a] * lanes), bs, lay)


def _port(c, a, b, lay):
    """The port's CPU f32 tensors and layout; an A broadcast from one
    matrix becomes an expanded view of it."""
    ct, bt = (torch.from_numpy(np.ascontiguousarray(x)) for x in (c, b))
    if a.strides[0] == 0:
        at = torch.from_numpy(np.array(a[0])).expand(
            a.shape[0], -1, -1)
    else:
        at = torch.from_numpy(np.ascontiguousarray(a))
    return ct, at, bt, interop.cone_from_reference(lay)


def _pair(data, pj, **kw):
    """(JAX batch result, port batch result) with the port on
    ``kernel='mega'``."""
    c, a, b, lay = data
    jkw = {k: (None if v is None else tuple(
        None if x is None else jnp.asarray(x) for x in v))
        if k == "warm_start" else v for k, v in kw.items()}
    rj = jax_solve_batch(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay,
                         pj, **jkw)
    pt = dataclasses.replace(interop.param_from_reference(pj), kernel="mega")
    tkw = {k: (None if v is None else tuple(
        None if x is None else torch.from_numpy(np.asarray(x)) for x in v))
        if k == "warm_start" else v for k, v in kw.items()}
    rt = tt.solve_batch(*_port(c, a, b, lay), pt, **tkw)
    return rj, rt


def _single(data, param, i):
    """Lane ``i`` solved alone by the port's ``solve_jit``."""
    c, a, b, lay = _port(*data)
    return tt.solve_jit(c[i], a[i], b[i], lay, param)


def _assert_lanes(rj, rt, data=None, param=None, parted=(), pj=None):
    """Per lane: the JAX batch's status and iterations, x within 1e-4
    where converged; with ``data``, also each lane's own single solve on
    the port bitwise (the plain version is the host loop per lane). The
    lanes in ``parted``, whose f32 trajectories part from JAX's by
    roundoff, are held to the JAX param ``pj`` instead: iterations within
    one check period, and x within eps_acc times 1 + |x|_inf of JAX's."""
    st = np.asarray(rj.status)
    assert rt.status.tolist() == st.tolist()
    conv = st == int(jt.SolverStatus.CONVERGED)
    assert conv.any()
    xt, xj = rt.x.numpy(), np.asarray(rj.x)
    it_t, it_j = rt.iters.numpy(), np.asarray(rj.iters)
    held = np.ones_like(conv)
    held[list(parted)] = False
    np.testing.assert_array_equal(it_t[held], it_j[held])
    np.testing.assert_allclose(xt[conv & held], xj[conv & held], atol=1e-4)
    if parted:
        gap = np.abs(it_t[~held] - it_j[~held])
        assert (gap <= pj.check_period).all(), gap
        dist = np.abs(xt[~held] - xj[~held]).max(-1)
        bound = pj.eps_acc * (1.0 + np.abs(xj[~held]).max(-1))
        assert (dist <= bound).all(), (dist, bound)
    assert rt.diag["route"] == "mega"
    if data is not None:
        for i in range(st.shape[0]):
            one = _single(data, param, i)
            assert one.iters == int(rt.iters[i])
            assert torch.equal(one.x, rt.x[i])


# (data, param kwargs, whether each lane is also solved alone, the lanes
# whose f32 trajectories part from JAX's by roundoff)
CASES = {
    "plain": (_lp_lanes, dict(eps_acc=1e-3), True, ()),
    # under Halpern, normalize and Ruiz, seeds 2 and 3 part from JAX when
    # solved alone too (tests/test_torch_megakernel.py holds seed 1 alone).
    # The first difference is Ruiz's: JAX's compiled scaling rounds most
    # entries of d and e one ulp away from its own eager scaling, which
    # the port's equals but for two entries. Amplified over the restarts,
    # that ends seed 2 one check period later (3630 against 3620) and
    # leaves seed 3's x 8.4e-4 away at the same count, against a gate of
    # 3.1e-3; the port's x stays as close to the f64 solution as JAX's
    "halpern_normalize_equil": (_lp_lanes_halpern, dict(
        eps_acc=1e-3, accel="halpern", normalize=True, equil_iters=10),
        False, (2, 3)),
    "shared_a": (_shared_a, dict(eps_acc=1e-3, accel="halpern"), True, ()),
    "soc_zero": (_soc_lanes, dict(eps_acc=1e-3), False, ()),
}


def _case_param(name):
    return jt.SolverParam(max_iter=60_000, check_period=10, kernel="mega",
                          **CASES[name][1])


@functools.lru_cache(maxsize=None)
def _case(name):
    """(data, JAX result, port result) of a case, run once per module."""
    data = CASES[name][0]()
    return (data,) + _pair(data, _case_param(name))


@pytest.mark.parametrize("name", list(CASES))
def test_batch_mega_matches_jax_mega(name):
    data, rj, rt = _case(name)
    if CASES[name][2]:
        _assert_lanes(rj, rt, data, dataclasses.replace(
            interop.param_from_reference(_case_param(name)), kernel="mega"))
    else:
        _assert_lanes(rj, rt, parted=CASES[name][3], pj=_case_param(name))


def _exp_pow_lanes(lanes=2):
    return _stack([_cone_mix_lp(
        [jt.expc(count=2), jt.powc(0.7), jt.rpos(1)],
        [_EXP_PT, _POW_PT, np.ones(1)], seed=s) for s in range(lanes)])


def test_batch_mega_exp_pow_matches_jax_host_engine():
    # exp and pow lanes (mega_kernel<true> on the card) against JAX's
    # batched host engine (kernel=''): the interpret-mode kernel is too
    # slow here, and the JAX package's tests hold the two equal
    pj = jt.SolverParam(max_iter=200_000, eps_acc=1e-4, check_period=20,
                        accel="halpern", kernel="")
    _assert_lanes(*_pair(_exp_pow_lanes(), pj))


def test_batch_mega_chunked_matches_jax_chunked():
    # lanes that stop in an earlier chunk stay stopped: each resumes with
    # a check at its taken point
    data, _, whole = _case("plain")
    rj, rt = _pair(data, _case_param("plain"), chunk_iters=500)
    _assert_lanes(rj, rt)
    assert rt.iters.tolist() == whole.iters.tolist()
    assert torch.equal(rt.x, whole.x)
