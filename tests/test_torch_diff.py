"""Implicit differentiation in the PyTorch port against the JAX package.

Twins of ``tests/test_diff.py`` on the CPU, in f64 (f32 where the JAX
test is f32): each instance is made once with numpy and goes through
``totsu_tpu.diff.make_differentiable_solver`` under ``jax.grad`` /
``jax.jvp`` and through the port's under ``torch.autograd`` /
``torch.func.jvp``. Each test holds the port's derivative

* within 1e-6 relative of the JAX package's (``assert_allclose`` with
  rtol 1e-6 and atol 1e-9: several entries are zero up to the solve's
  1e-10 accuracy, about 1e-10 in both packages), and
* against central differences of the port's own solves at the JAX
  test's tolerances.

The two ``BlockedEllOp`` twins are in ``test_torch_diff_ell.py`` (the
port's indirect engine takes about 17 s on one CPU core for one of
them). ``test_vmapped_batch_gradients`` (``test_diff.py:115``) holds
the port's batch-leading inputs (a lockstep ``solve_batch`` forward, each
lane's rule backward) against ``jax.vmap(jax.grad(...))``.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
from totsu_tpu.diff import make_differentiable_solver as jmds
import totsu_tpu_torch as tt
from totsu_tpu_torch import diff as tdiff
from totsu_tpu_torch.diff import make_differentiable_solver as tmds
from totsu_tpu_torch.ops.kernels import _build
from totsu_tpu_torch.ops.kernels import cone_proj as cp
from totsu_tpu_torch.ops.kernels import dual_matvec as dm
from totsu_tpu_torch.solver import dproj
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

PJ = jt.SolverParam(max_iter=200_000, eps_acc=1e-10, method="direct")
PT = tt.SolverParam(max_iter=200_000, eps_acc=1e-10, method="direct")
#: port vs JAX package
RTOL, ATOL = 1e-6, 1e-9


def _t(v, dtype=torch.float64, grad=False):
    return torch.tensor(np.asarray(v), dtype=dtype, requires_grad=grad)


def nondegenerate_lp():
    # min c.x s.t. Gx <= h with a unique nondegenerate vertex solution
    c = np.array([1.0, 2.0])
    g = np.array([[-1.0, 0.0], [0.0, -1.0], [1.0, 1.0]])
    h = np.array([0.0, 0.0, 4.0])
    return c, g, h


def fd_grad(f, x, eps=1e-6):
    x = np.asarray(x, dtype=np.float64)
    g = np.zeros_like(x)
    for i in range(x.size):
        xp = x.copy()
        xm = x.copy()
        xp.flat[i] += eps
        xm.flat[i] -= eps
        g.flat[i] = (f(xp) - f(xm)) / (2 * eps)
    return g


def _grad(loss, theta):
    """d loss / d theta in the port (theta a numpy array)."""
    t = _t(theta, grad=True)
    (g,) = torch.autograd.grad(loss(t), t)
    return g.numpy()


def _lp_solvers(mode="vjp"):
    return (jmds(jt.ConeLayout([jt.rpos(3)]), PJ, mode=mode),
            tmds(tt.ConeLayout([tt.rpos(3)]), PT, mode=mode))


def test_grad_wrt_b_matches_fd():
    c, g, h = nondegenerate_lp()
    sj, st = _lp_solvers()
    gj = jax.grad(lambda hv: jnp.sum(sj(jnp.asarray(c), jnp.asarray(g),
                                        hv)[0] ** 2))(jnp.asarray(h))

    def loss(hv):
        return torch.sum(st(_t(c), _t(g), hv)[0] ** 2)

    grad = _grad(loss, h)
    np.testing.assert_allclose(grad, np.asarray(gj), rtol=RTOL, atol=ATOL)
    fd = fd_grad(lambda hv: float(loss(_t(hv))), h)
    np.testing.assert_allclose(grad, fd, rtol=1e-4, atol=1e-6)


def test_grad_wrt_c_matches_fd():
    c, g, h = nondegenerate_lp()
    sj, st = _lp_solvers()
    w = np.array([1.0, -2.0])

    def loss_j(cv):
        x, y = sj(cv, jnp.asarray(g), jnp.asarray(h))
        return jnp.sum(x * jnp.asarray(w)) + jnp.sum(y)

    def loss(cv):
        x, y = st(cv, _t(g), _t(h))
        return torch.sum(x * _t(w)) + torch.sum(y)

    grad = _grad(loss, c)
    np.testing.assert_allclose(grad, np.asarray(jax.grad(loss_j)(
        jnp.asarray(c))), rtol=RTOL, atol=ATOL)
    fd = fd_grad(lambda cv: float(loss(_t(cv))), c)
    np.testing.assert_allclose(grad, fd, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("as_op", [False, True], ids=["tensor", "DenseOp"])
def test_grad_wrt_a_matches_fd(as_op):
    c, g, h = nondegenerate_lp()
    sj, st = _lp_solvers()
    gj = jax.grad(lambda gv: jnp.sum(sj(jnp.asarray(c), gv,
                                        jnp.asarray(h))[0]))(jnp.asarray(g))

    def loss(gv):
        a = tt.DenseOp(gv) if as_op else gv
        return torch.sum(st(_t(c), a, _t(h))[0])

    grad = _grad(loss, g)
    np.testing.assert_allclose(grad, np.asarray(gj), rtol=RTOL, atol=ATOL)
    fd = fd_grad(lambda gv: float(loss(_t(gv.reshape(g.shape)))),
                 g).reshape(g.shape)
    np.testing.assert_allclose(grad, fd, rtol=1e-4, atol=1e-6)


def test_grad_through_qp():
    # tune h to pull the QP solution toward a target
    g = [[-1.0, 0.0], [0.0, -1.0]]
    prob_j = jt.problems.qp(jnp.eye(2), jnp.zeros(2), g=g, h=[-1.0, -1.0])
    prob = tt.problems.qp(torch.eye(2, dtype=torch.float64),
                          torch.zeros(2, dtype=torch.float64), g=g,
                          h=[-1.0, -1.0], device="cpu")
    sj = jmds(prob_j.cone, PJ)
    st = tmds(prob.cone, PT)
    target = np.array([2.0, 3.0])

    def loss_j(hpart):
        x, _ = sj(prob_j.c, prob_j.a.a, prob_j.b.at[-2:].set(hpart))
        return jnp.sum((x[:2] - jnp.asarray(target)) ** 2)

    def loss(hpart):
        x, _ = st(prob.c, prob.a.a, torch.cat([prob.b[:-2], hpart]))
        return torch.sum((x[:2] - _t(target)) ** 2)

    h0 = np.array([-1.0, -1.0])
    grad = _grad(loss, h0)
    np.testing.assert_allclose(grad, np.asarray(jax.grad(loss_j)(
        jnp.asarray(h0))), rtol=RTOL, atol=ATOL)
    fd = fd_grad(lambda hv: float(loss(_t(hv))), h0)
    np.testing.assert_allclose(grad, fd, rtol=1e-3, atol=1e-5)
    # one gradient step reduces the loss
    assert float(loss(_t(h0 - 0.1 * grad))) < float(loss(_t(h0)))


def test_jvp_forward_mode_matches_fd():
    c, g, h = nondegenerate_lp()
    sj, st = _lp_solvers("jvp")
    db = np.random.default_rng(0).normal(size=3)
    (_, _), (dxj, dyj) = jax.jvp(
        lambda b_: sj(jnp.asarray(c), jnp.asarray(g), b_),
        (jnp.asarray(h),), (jnp.asarray(db),))
    (_, _), (dx, dy) = torch.func.jvp(lambda b_: st(_t(c), _t(g), b_),
                                      (_t(h),), (_t(db),))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dxj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dy.numpy(), np.asarray(dyj), rtol=RTOL,
                               atol=ATOL)
    eps = 1e-6
    xp, _ = st(_t(c), _t(g), _t(h + eps * db))
    xm, _ = st(_t(c), _t(g), _t(h - eps * db))
    fd = (xp.numpy() - xm.numpy()) / (2 * eps)
    np.testing.assert_allclose(dx.numpy(), fd, rtol=1e-4, atol=1e-6)
    # torch.autograd.forward_ad reaches the same rule
    import torch.autograd.forward_ad as fwad
    with fwad.dual_level():
        xd, _ = st(_t(c), _t(g), fwad.make_dual(_t(h), _t(db)))
        np.testing.assert_array_equal(fwad.unpack_dual(xd).tangent.numpy(),
                                      dx.numpy())


def test_vmapped_batch_gradients():
    """Batched learning loops: the gradient of a batch-leading b (one
    lockstep solve_batch forward) must match jax.vmap(jax.grad(...)) and
    each lane's own gradient."""
    c, g, h = nondegenerate_lp()
    sj, st = _lp_solvers()

    def jloss(b_):
        x, _ = sj(jnp.asarray(c), jnp.asarray(g), b_)
        return jnp.sum(x ** 2)

    rng = np.random.default_rng(1)
    hb = h[None, :] + 0.1 * rng.normal(size=(4, 3))
    gj = jax.vmap(jax.grad(jloss))(jnp.asarray(hb))
    gb = _grad(lambda bv: torch.sum(st(_t(c), _t(g), bv)[0] ** 2), hb)
    assert len(st.stats["lsqr_steps"]) == 4
    np.testing.assert_allclose(gb, np.asarray(gj), rtol=RTOL, atol=ATOL)
    for i in range(4):
        gi = _grad(lambda bv: torch.sum(st(_t(c), _t(g), bv)[0] ** 2),
                   hb[i])
        np.testing.assert_allclose(gb[i], gi, rtol=1e-6, atol=1e-9)
    # a shared input's cotangent sums the lanes'; forward mode per lane
    cv = _t(c, grad=True)
    x, _ = st(cv, _t(g), _t(hb))
    (gc,) = torch.autograd.grad(torch.sum(x ** 2), cv)
    per_lane = [_grad(lambda cc: torch.sum(st(cc, _t(g), _t(hb[i]))[0]
                                           ** 2), c) for i in range(4)]
    np.testing.assert_allclose(gc.numpy(), np.sum(per_lane, axis=0),
                               rtol=1e-6, atol=1e-9)
    _, sf = _lp_solvers("jvp")
    db = rng.normal(size=(4, 3))
    (_, _), (dx, _) = torch.func.jvp(lambda b_: sf(_t(c), _t(g), b_),
                                     (_t(hb),), (_t(db),))
    for i in range(4):
        (_, _), (dxi, _) = torch.func.jvp(
            lambda b_: sf(_t(c), _t(g), b_), (_t(hb[i]),), (_t(db[i]),))
        np.testing.assert_allclose(dx[i].numpy(), dxi.numpy(), rtol=1e-6,
                                   atol=1e-9)
    # a structured A shared by the lanes (x <= b with c < 0: x = b, so
    # d sum(x^2)/d b = 2 b): each lane as its own single solve
    diag = tt.DiagOp(torch.ones(3, dtype=torch.float64))
    c3 = _t([-1.0, -2.0, -3.0])
    gd = _grad(lambda bv: torch.sum(st(c3, diag, bv)[0] ** 2), hb)
    np.testing.assert_allclose(gd, 2 * hb, rtol=1e-6)
    xd, _ = st(c3, diag, _t(hb))
    for i in range(4):
        xi, _ = st(c3, diag, _t(hb[i]))
        np.testing.assert_allclose(xd[i].detach().numpy(),
                                   xi.detach().numpy(), rtol=1e-9,
                                   atol=1e-12)
        gi = _grad(lambda bv: torch.sum(st(c3, diag, bv)[0] ** 2), hb[i])
        np.testing.assert_allclose(gd[i], gi, rtol=1e-6, atol=1e-9)


def test_gradients_at_scale_seconds():
    """n + m = 2,100 in seconds: the LSQR backward never builds the
    (n+m+1)^2 matrix. The box LP keeps the solve itself fast."""
    rng = np.random.default_rng(2)
    n = 700
    m2 = 1400
    c = rng.normal(size=n) + np.sign(rng.normal(size=n))
    eye = np.eye(n)
    g = np.concatenate([eye, -eye])
    h = np.ones(m2)
    st = tmds(tt.ConeLayout([tt.rpos(m2)]),
              tt.SolverParam(max_iter=200_000, eps_acc=1e-9,
                             method="direct"))

    def loss(b_):
        return torch.sum(st(_t(c), _t(g), b_)[0] ** 2)

    t0 = time.perf_counter()
    grad = _grad(loss, h)
    dt = time.perf_counter() - t0
    assert np.isfinite(grad).all()
    # x* = -sign(c) on the box: d||x||^2/dh is 2 on each coordinate's
    # active box row and 0 elsewhere, which the JAX test spot-checks by
    # finite differences at three coordinates
    active = np.where(c > 0, n + np.arange(n), np.arange(n))
    closed = np.zeros(m2)
    closed[active] = 2.0
    np.testing.assert_allclose(grad, closed, rtol=5e-3, atol=1e-5)
    f = lambda hv: float(loss(_t(hv)))  # noqa: E731
    for i in (0, n // 2, m2 - 1):
        hp = h.copy()
        hp[i] += 1e-5
        hm = h.copy()
        hm[i] -= 1e-5
        fd = (f(hp) - f(hm)) / 2e-5
        np.testing.assert_allclose(grad[i], fd, rtol=5e-3, atol=1e-5)
    assert dt < 60.0, f"gradient took {dt:.1f}s (want seconds, not cubic)"


def test_grad_through_qp_builder_params():
    """Gradients w.r.t. the QP's natural parameters (P, q) through the
    port's qp() reduction (its eigh square root keeps the graph)."""
    g = [[-1.0, 0.0], [0.0, -1.0]]
    h = [-1.0, -1.0]
    lay = tt.problems.qp(torch.eye(2, dtype=torch.float64),
                         torch.zeros(2, dtype=torch.float64), g=g, h=h,
                         device="cpu").cone
    st = tmds(lay, PT)
    sj = jmds(jt.problems.qp(jnp.eye(2), jnp.zeros(2), g=g, h=h).cone, PJ)
    target = np.array([1.5, 2.5])

    def loss_j(theta):
        prob = jt.problems.qp(jnp.diag(theta[:2]) + 0.5 * jnp.eye(2),
                              theta[2:], g=g, h=h)
        x, _ = sj(prob.c, prob.a.a, prob.b)
        return jnp.sum((x[:2] - jnp.asarray(target)) ** 2)

    def loss(theta):
        prob = tt.problems.qp(torch.diag(theta[:2]) + 0.5 * torch.eye(
            2, dtype=torch.float64), theta[2:], g=g, h=h, device="cpu")
        x, _ = st(prob.c, prob.a.a, prob.b)
        return torch.sum((x[:2] - _t(target)) ** 2)

    theta0 = np.array([1.0, 0.8, -1.0, -2.0])
    grad = _grad(loss, theta0)
    np.testing.assert_allclose(grad, np.asarray(jax.grad(loss_j)(
        jnp.asarray(theta0))), rtol=RTOL, atol=ATOL)
    fd = fd_grad(lambda tv: float(loss(_t(tv))), theta0, eps=1e-5)
    np.testing.assert_allclose(grad, fd, rtol=2e-3, atol=1e-5)
    assert float(loss(_t(theta0 - 0.05 * grad))) < float(loss(_t(theta0)))


def test_grad_through_socp_builder_params():
    """Builder-param gradients through socp(): min f.x s.t.
    ||(x1, x2)|| <= theta0, x1 + x2 >= theta1."""
    f = np.array([1.0, 0.6])

    def build_j(theta):
        return jt.problems.socp(
            jnp.asarray(f), g_list=[-jnp.eye(2), jnp.zeros((0, 2))],
            h_list=[jnp.zeros(2), jnp.zeros(0)],
            c_list=[jnp.zeros(2), jnp.array([1.0, 1.0])],
            d_list=[theta[0], -theta[1]])

    def build(theta):
        z = torch.zeros
        return tt.problems.socp(
            _t(f), g_list=[-torch.eye(2, dtype=torch.float64),
                           z(0, 2, dtype=torch.float64)],
            h_list=[z(2, dtype=torch.float64), z(0, dtype=torch.float64)],
            c_list=[z(2, dtype=torch.float64), _t([1.0, 1.0])],
            d_list=[theta[0], -theta[1]])

    theta0 = np.array([2.0, 1.0])
    sj = jmds(build_j(jnp.asarray(theta0)).cone, PJ)
    st = tmds(build(_t(theta0)).cone, PT)
    target = np.array([-0.9, -0.1])

    def loss_j(theta):
        prob = build_j(theta)
        x, _ = sj(prob.c, prob.a.a, prob.b)
        return jnp.sum((x - jnp.asarray(target)) ** 2)

    def loss(theta):
        prob = build(theta)
        x, _ = st(prob.c, prob.a.a, prob.b)
        return torch.sum((x - _t(target)) ** 2)

    grad = _grad(loss, theta0)
    np.testing.assert_allclose(grad, np.asarray(jax.grad(loss_j)(
        jnp.asarray(theta0))), rtol=RTOL, atol=ATOL)
    fd = fd_grad(lambda tv: float(loss(_t(tv))), theta0, eps=1e-5)
    np.testing.assert_allclose(grad, fd, rtol=2e-3, atol=1e-6)


def test_grad_through_sdp_builder_params():
    """Builder-param gradients through sdp(): diag(theta - x) <= 0 makes
    x = theta, so d||x||^2/dtheta = 2 theta."""
    def build_j(theta):
        return jt.problems.sdp(
            jnp.array([1.0, 1.0]),
            jnp.stack([-jnp.diag(jnp.array([1.0, 0.0])),
                       -jnp.diag(jnp.array([0.0, 1.0])), jnp.diag(theta)]),
            psd_method="eigh")

    def build(theta):
        return tt.problems.sdp(
            _t([1.0, 1.0]),
            torch.stack([-torch.diag(_t([1.0, 0.0])),
                         -torch.diag(_t([0.0, 1.0])), torch.diag(theta)]),
            psd_method="eigh")

    theta0 = np.array([3.0, 4.0])
    sj = jmds(build_j(jnp.asarray(theta0)).cone, PJ)
    st = tmds(build(_t(theta0)).cone, PT)

    def loss_j(theta):
        prob = build_j(theta)
        return jnp.sum(sj(prob.c, prob.a.a, prob.b)[0] ** 2)

    def loss(theta):
        prob = build(theta)
        return torch.sum(st(prob.c, prob.a.a, prob.b)[0] ** 2)

    grad = _grad(loss, theta0)
    np.testing.assert_allclose(grad, 2.0 * theta0, rtol=1e-4)
    np.testing.assert_allclose(grad, np.asarray(jax.grad(loss_j)(
        jnp.asarray(theta0))), rtol=RTOL, atol=ATOL)
    fd = fd_grad(lambda tv: float(loss(_t(tv))), theta0, eps=1e-5)
    np.testing.assert_allclose(grad, fd, rtol=2e-3, atol=1e-6)


def test_grad_f32_matches_fd():
    """f32 gradients: the default lsqr_rtol resolves to 30 eps, and the
    gradient matches the f64 one at the JAX test's tolerance."""
    c, g, h = nondegenerate_lp()
    lay = tt.ConeLayout([tt.rpos(3)])
    st = tmds(lay, tt.SolverParam(max_iter=200_000, eps_acc=1e-6,
                                  method="direct"))
    sj = jmds(jt.ConeLayout([jt.rpos(3)]),
              jt.SolverParam(max_iter=200_000, eps_acc=1e-6,
                             method="direct"))
    f32 = torch.float32
    hv = _t(h, f32, grad=True)
    (grad,) = torch.autograd.grad(
        torch.sum(st(_t(c, f32), _t(g, f32), hv)[0] ** 2), hv)
    assert grad.dtype == torch.float32
    assert tdiff._rtol(None, f32) == 30.0 * float(torch.finfo(f32).eps)
    st64 = tmds(lay, PT)
    g64 = _grad(lambda b_: torch.sum(st64(_t(c), _t(g), b_)[0] ** 2), h)
    np.testing.assert_allclose(grad.numpy(), g64, rtol=5e-3, atol=1e-4)
    gj = jax.grad(lambda b_: jnp.sum(sj(
        jnp.asarray(c, jnp.float32), jnp.asarray(g, jnp.float32),
        b_)[0] ** 2))(jnp.asarray(h, jnp.float32))
    np.testing.assert_allclose(grad.numpy(), np.asarray(gj), rtol=5e-3,
                               atol=1e-4)


def test_modes_define_one_direction():
    c, g, h = nondegenerate_lp()
    _, st = _lp_solvers("jvp")
    hv = _t(h, grad=True)
    with pytest.raises(RuntimeError, match="forward mode only"):
        torch.sum(st(_t(c), _t(g), hv)[0]).backward()
    _, sv = _lp_solvers("vjp")
    with pytest.raises(RuntimeError, match="reverse mode only"):
        torch.func.jvp(lambda b_: sv(_t(c), _t(g), b_), (_t(h),),
                       (_t(h),))
    with pytest.raises(ValueError, match="unknown mode"):
        tmds(tt.ConeLayout([tt.rpos(3)]), PT, mode="hvp")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it reaches the CUDA branch
    of a wrapper on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_lsqr_products_launch_the_kernel_or_raise(monkeypatch):
    # LSQR's products on a CUDA tensor go to the dual_matvec kernel: a
    # failed build raises, with no fallback to the plain version and no
    # launch counted
    def failed_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu: stubbed")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "load", failed_build)
    monkeypatch.setattr(dm, "dual_matvec_plain", plain)
    monkeypatch.setattr(cp, "cone_proj_plain", plain)
    c, g, h = nondegenerate_lp()
    a = torch.Tensor._make_subclass(_OnCard, _t(g))
    before = dm.launches, cp.launches
    u = torch.Tensor._make_subclass(_OnCard, _t(np.ones(6)))
    # this CPU-only torch cannot make the kernel's output on the card:
    # the CUDA branch raises there, before the build
    with pytest.raises((RuntimeError, AssertionError),
                       match="nvcc failed|not compiled with CUDA"):
        tdiff._q_apply(_t(c), tt.DenseOp(a), _t(h), u)
    # DPi's exp/pow projection goes to kernel B
    seg = torch.Tensor._make_subclass(_OnCard, _t(np.arange(6.0) - 2.0))
    for f in (tt.expc(2), tt.powc(0.5, 2)):
        with pytest.raises(RuntimeError, match="nvcc failed for cone_proj"):
            dproj.factor_dproj(f, seg, True)
    assert (dm.launches, cp.launches) == before


def test_rules_see_plain_tensors(monkeypatch):
    # under torch.func the rule's saved tensors and tangents come wrapped,
    # and a wrapper has no storage: the kernels' wrappers read data_ptr()
    # on the card, so the rule must hand them plain tensors
    real = dm.dual_matvec_plain

    def needs_storage(a, u, v):
        for t in (a, u, v):
            t.data_ptr()
        return real(a, u, v)

    monkeypatch.setattr(dm, "dual_matvec_plain", needs_storage)
    c, g, h = nondegenerate_lp()
    _, sj = _lp_solvers("jvp")
    db = np.random.default_rng(0).normal(size=3)
    (_, _), (dx, _) = torch.func.jvp(lambda b_: sj(_t(c), _t(g), b_),
                                     (_t(h),), (_t(db),))
    _, sv = _lp_solvers("vjp")
    grad = torch.func.grad(lambda b_: torch.sum(sv(_t(c), _t(g), b_)[0]
                                                ** 2))(_t(h))
    np.testing.assert_allclose(grad.numpy(), _grad(
        lambda b_: torch.sum(sv(_t(c), _t(g), b_)[0] ** 2), h), rtol=1e-12,
        atol=1e-15)
    assert np.isfinite(dx.numpy()).all()


@pytest.mark.parametrize("dtype, iters, rtol", [
    (np.float64, 10, 1e-12), (np.float64, 400, 1e-12),
    (np.float32, 10, 1e-5)])
def test_lsqr_matches_the_jax_package(dtype, iters, rtol):
    # the port's LSQR (its plane rotation in host scalars of the vectors'
    # precision) against the JAX package's lax.while_loop on a singular
    # least-squares problem (rank 12): cut at 10 steps, the same iterate;
    # run to its tolerance, the same min-norm solution. The tolerances,
    # 1e-12 in f64 and 1e-5 in f32 (about 5,000 and 80 eps), cover the
    # products' summation order
    from totsu_tpu.diff import _lsqr as jlsqr
    rng = np.random.default_rng(12)
    a = (rng.normal(size=(40, 12)) @ rng.normal(size=(12, 30))).astype(dtype)
    rhs = rng.normal(size=40).astype(dtype)
    stop = 1e-12 if dtype == np.float64 else 30 * np.finfo(dtype).eps
    want = np.asarray(jlsqr(lambda v: jnp.asarray(a) @ v,
                            lambda u: jnp.asarray(a).T @ u,
                            jnp.asarray(rhs), iters, stop))
    at = torch.from_numpy(a)
    got, steps = tdiff._lsqr(lambda v: at @ v, lambda u: at.T @ u,
                             torch.from_numpy(rhs), iters, stop)
    assert got.dtype == at.dtype and 0 < steps <= iters
    assert np.linalg.norm(got.numpy() - want) <= rtol * np.linalg.norm(want)
