"""The batched megakernel's other paths on the CPU: a warm start,
``BatchRunner``, the batch-leading differentiable forward, the envelope
and ``kernel='auto'``, against the JAX package where it has the path
(``tests/test_torch_batch_mega.py`` states how the two sides run)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.ops.kernels import megakernel as mk

from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

from test_torch_batch_mega import _assert_lanes, _lp_lanes, _pair, _port


def test_batch_mega_warm_start_matches_jax():
    # lanes seeded near their solutions: the kernel checks the seed first
    data = _lp_lanes()
    c, a, b, lay = data
    cold = tt.solve_batch(*_port(*data), tt.SolverParam(
        max_iter=60_000, eps_acc=1e-2, check_period=10, kernel="mega"))
    ws = (cold.x.numpy(), cold.y.numpy())
    pj = jt.SolverParam(max_iter=60_000, eps_acc=1e-3, check_period=10,
                        kernel="mega")
    rj, rt = _pair(data, pj, warm_start=ws)
    _assert_lanes(rj, rt)


def test_batch_runner_takes_the_megakernel():
    # BatchRunner(kernel='mega') against the JAX package's BatchRunner with
    # kernel='mega'; its cache records the route its tier took
    from totsu_tpu.runtime.batcher import BatchRunner as JaxRunner
    c, a, b, lay = _lp_lanes((0, 3))
    pj = jt.SolverParam(max_iter=60_000, eps_acc=1e-3, check_period=10,
                        kernel="mega")
    rj = JaxRunner(pj).map([(jnp.asarray(c[i]), jnp.asarray(a[i]),
                             jnp.asarray(b[i]), lay) for i in range(2)])
    tl = interop.cone_from_reference(lay)
    runner = tt.BatchRunner(interop.param_from_reference(pj), device="cpu")
    rt = runner.map([(torch.from_numpy(c[i]), torch.from_numpy(a[i]),
                      torch.from_numpy(b[i]), tl) for i in range(2)])
    for one_j, one_t in zip(rj, rt):
        assert one_t.status == int(one_j.status)
        assert one_t.iters == int(one_j.iters)
        np.testing.assert_allclose(one_t.x.numpy(), np.asarray(one_j.x),
                                   atol=1e-4)
    assert list(runner.routes.values()) == [("mega",)]


def test_batch_diff_forward_on_the_megakernel(monkeypatch):
    # a batch-leading differentiable solve with kernel='mega': the forward
    # is the batched megakernel, each lane's rule the backward, against
    # jax.vmap(jax.grad(...)) (f32: atol 1e-5)
    from totsu_tpu.diff import make_differentiable_solver as jmds
    c = np.array([1.0, 2.0], np.float32)
    g = np.array([[-1.0, 0.0], [0.0, -1.0], [1.0, 1.0]], np.float32)
    h = np.array([0.0, 0.0, 4.0], np.float32)
    kw = dict(max_iter=200_000, eps_acc=1e-6, check_period=10,
              kernel="mega")
    sj = jmds(jt.ConeLayout([jt.rpos(3)]), jt.SolverParam(**kw))
    st = tt.make_differentiable_solver(tt.ConeLayout([tt.rpos(3)]),
                                       tt.SolverParam(**kw))
    hb = (h + 0.1 * np.random.default_rng(1).normal(size=(2, 3))).astype(
        np.float32)
    gj = jax.vmap(jax.grad(lambda b_: jnp.sum(
        sj(jnp.asarray(c), jnp.asarray(g), b_)[0] ** 2)))(jnp.asarray(hb))
    routes = []
    real = mk.solve_mega_batch_plain
    monkeypatch.setattr(mk, "solve_mega_batch_plain", lambda *a_, **k_: (
        routes.append(a_[0].shape[0]) or real(*a_, **k_)))
    hv = torch.tensor(hb, requires_grad=True)
    x, _ = st(torch.tensor(c), torch.tensor(g), hv)
    (gt,) = torch.autograd.grad(torch.sum(x ** 2), hv)
    assert routes == [2]
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)


def test_batch_mega_envelope_rejections():
    # as the single solve: f64 data, matvec_dtype and accel='restart'
    # are outside the kernel; 'auto' keeps the host loop for them
    c, a, b, lay = _lp_lanes((0, 1))
    ct, at, bt, tl = _port(c, a, b, lay)
    p = tt.SolverParam(max_iter=50, kernel="mega")
    for args, param in (
            ((ct.double(), at.double(), bt.double()), p),
            ((ct, at, bt), dataclasses.replace(p, matvec_dtype="bfloat16")),
            ((ct, at, bt), dataclasses.replace(p, accel="restart"))):
        with pytest.raises(ValueError, match="kernel='mega'"):
            tt.solve_batch(*args, tl, param)
        auto = tt.solve_batch(*args, tl, dataclasses.replace(
            param, kernel="auto"))
        assert auto.diag["route"] == "loop"
    with pytest.raises(ValueError, match="CUDA"):
        mk.solve_mega_batch_cuda(at, ct, bt, ct, bt, (ct, bt, bt, ct[:, 0]),
                                 (ct, bt, ct[:, 0]), (ct, bt, bt, ct[:, 0]),
                                 (ct, bt, ct[:, 0]), tl, eps_acc=1e-3,
                                 eps_inf=1e-6, eps_zero=1e-12, max_iter=10,
                                 check_period=5)


def test_batch_mega_auto_keeps_the_host_loop_on_the_cpu(monkeypatch):
    # 'auto' takes the kernel only on the card, as JAX only on a TPU; the
    # fast profile resolves on lane 0 and, off the card, never picks it
    def boom(*args, **kwargs):
        raise AssertionError("kernel='auto' took the megakernel on the CPU")

    monkeypatch.setattr(mk, "solve_mega_batch", boom)
    c, a, b, lay = _lp_lanes((0, 1))
    args = _port(c, a, b, lay)
    auto = tt.solve_batch(*args, tt.SolverParam(
        max_iter=60_000, eps_acc=1e-3, check_period=10, kernel="auto"))
    assert auto.diag["route"] == "loop" and (auto.status == 1).all()
    fast = tt.solve_batch(*args, tt.SolverParam(max_iter=60_000,
                                                eps_acc=1e-3,
                                                profile="fast"))
    assert (fast.status == 1).all()
