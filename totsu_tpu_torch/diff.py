"""Differentiating through conic program solutions.

Port of ``totsu_tpu.diff``: the conic implicit-function approach of
Agrawal, Barratt, Boyd, Busseti and Moursi ("Differentiating through a
cone program", 2019, the engine behind diffcp / cvxpylayers). At a
converged solution the homogeneous residual map

    N(z) = Q Pi(z) - (Pi(z) - z) = 0,
    Q = [[0, A', c], [-A, 0, b], [-c', -b', 0]],
    Pi = projection onto C = R^n x K* x R+

is differentiable wherever the cone projection is, and

    M dz = -dQ u,     M = (Q - I) DPi(z) + I,   u = Pi(z)

gives the solution's sensitivities. M is never materialized: both rules
solve with LSQR (min-norm least squares; M is singular, z spans its
null space), whose every step applies M and M^T once each, so one Q
product each: on a dense A on the card that is one launch of the
``dual_matvec`` kernel per product.

What differs from the JAX package, on purpose:

* DPi comes in closed form from ``solver/dproj.py``, built once per
  backward or forward call, not from ``jax.jvp`` / ``jax.vjp`` through
  the projections' iterations: on the card the exp/pow projection is
  kernel B and the 'jacobi' PSD projection kernel J, which have no
  derivative;
* LSQR is a host loop with one host read per step (like the direct
  engine's CG), the JAX ``lax.while_loop``'s steps and stopping rule:
  the read brings the step's two norms, and the plane rotation and the
  exit test run in host scalars of the vectors' precision, so a step
  launches about 30 kernels on the card, not 70;
* the rule is a ``torch.autograd.Function``: ``mode='vjp'`` saves for
  ``backward`` (``torch.autograd.grad``, ``.backward()``), ``mode='jvp'``
  for ``jvp`` (``torch.func.jvp``, ``torch.autograd.forward_ad``); each
  mode defines one direction, as in the JAX package;
* the A cotangent lives in the operator's own parameters: the solver
  hands the floating tensors of ``a`` (a dense tensor, or a ``LinOp``'s
  fields: ``BlockedEllOp``'s ``blocks`` and ``blocks_t``, ``CustomOp``'s
  ``params``, the children of the stacks) to the Function as inputs;
  integer leaves (tile-column indices) and sparse tensors get no
  gradient. A dense A takes the closed form -(u_y w_x' - w_y u_x'); any
  other operator the gradient of w_x . A'u_y - w_y . A u_x by autograd
  through its ``matvec`` / ``rmatvec``, which are plain PyTorch on every
  operator. Forward-mode tangents of a structured A come the same way:
  ``torch.func.jvp(lambda blk, blk_t: solver(c, BlockedEllOp(...,
  blk, ..., blk_t, ...), b), ...)``.

The solve must converge and the solution sit at a differentiable
(strictly complementary) point, else the gradients are subgradient-like.
No reference counterpart.
"""

import contextlib
import dataclasses
from typing import Any, Callable, List

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from totsu_tpu_torch.solver.cone import ConeLayout, resolve_auto_methods
from totsu_tpu_torch.solver.batched import solve_batch_jit
from totsu_tpu_torch.solver.conic import solve_jit
from totsu_tpu_torch.solver.dproj import dproj_at
from totsu_tpu_torch.solver.operator import (BatchedDenseOp, BatchedOp,
                                            DenseOp, LinOp, _flatten,
                                            full_f32_matmul, pin_dtype)
from totsu_tpu_torch.solver.params import SolverParam


def _rtol(lsqr_rtol, dtype: torch.dtype) -> float:
    """The LSQR stopping tolerance for the solve's dtype: the default
    (None) is 1e-12 in f64 and 30 eps otherwise (1e-12 is out of reach
    in f32 and would run every gradient to the iteration cap)."""
    if lsqr_rtol is not None:
        return float(lsqr_rtol)
    return 1e-12 if dtype == torch.float64 else \
        30.0 * float(torch.finfo(dtype).eps)


def _q_apply(c, a_op: LinOp, b, u, cb=None):
    """Q u through the operator interface: one ``dual_matvec`` (the
    kernel for a dense A on the card) and four small operations. ``cb``
    is (c, b) concatenated, which a loop passes in once."""
    n = c.shape[0]
    cb = torch.cat([c, b]) if cb is None else cb
    a_ux, at_uy = a_op.dual_matvec(u[:n], u[n:-1])
    # (A'u_y + c u_t, -A u_x + b u_t, -c.u_x - b.u_y)
    out = torch.cat([at_uy, a_ux, (cb @ u[:-1]).reshape(1)])
    out[n:].neg_()
    out[:-1].addcmul_(cb, u[-1:])
    return out


def _lsqr(matvec, rmatvec, rhs, iters: int, rtol: float):
    """Paige-Saunders LSQR: min-norm least-squares solve of ``A w ~ rhs``
    with ``matvec`` (A v) and ``rmatvec`` (A' u); a singular A is fine.
    The JAX package's steps and stopping rule: stop when ||A' r|| (LSQR's
    phibar alpha |cs|) falls to rtol ||A' rhs|| or after ``iters`` steps.
    Returns (w, steps). Each step ends with one host read, of its two
    norms; the scalar recurrence then runs on the host in the vectors'
    precision, so the step's vector updates take their factors as
    arguments and launch nothing for them."""
    real = np.float64 if rhs.dtype == torch.float64 else np.float32
    eps = real(torch.finfo(rhs.dtype).tiny)
    one = real(1.0)
    nrm = torch.linalg.vector_norm

    def norms(*ts):
        return [real(t) for t in torch.stack(ts).tolist()]

    beta1_t = nrm(rhs)
    u = rhs / torch.clamp(beta1_t, min=float(eps))
    v = rmatvec(u)
    alpha_t = nrm(v)
    v = v / torch.clamp(alpha_t, min=float(eps))
    beta1, alpha = norms(beta1_t, alpha_t)
    wv = v
    x = torch.zeros_like(v)
    arnorm0 = max(alpha * beta1, eps)
    rhobar, alphak, phibar, cs = alpha, alpha, beta1, one
    k = 0
    while k < iters and phibar * alphak * abs(cs) > real(rtol) * arnorm0:
        u = torch.sub(matvec(v), u, alpha=float(alphak))
        beta_t = nrm(u)
        u = u / torch.clamp(beta_t, min=float(eps))
        v = torch.addcmul(rmatvec(u), v, beta_t, value=-1)
        alpha_t = nrm(v)
        v = v / torch.clamp(alpha_t, min=float(eps))
        beta, alphak = norms(beta_t, alpha_t)
        rho = max(np.sqrt(rhobar * rhobar + beta * beta), eps)
        cs = rhobar / rho
        sn = beta / rho
        theta = sn * alphak
        rhobar = -cs * alphak
        phi = cs * phibar
        phibar = sn * phibar
        x = torch.add(x, wv, alpha=float(phi / rho))
        wv = torch.add(v, wv, alpha=-float(theta / rho))
        k += 1
    return x, k


def _m_ops(dp, c, a_op: LinOp, b):
    """Appliers of M = (Q - I) DPi(z) + I and M' = DPi(z)' (Q' - I) + I
    (Q is skew-symmetric: Q' = -Q), from ``dp``, DPi's data at z."""
    cb = torch.cat([c, b])

    def m_apply(v):
        d = dp.apply(v)
        return _q_apply(c, a_op, b, d, cb).sub_(d).add_(v)

    def mt_apply(w):
        return dp.apply_t(_q_apply(c, a_op, b, w, cb).add_(w).neg_()).add_(w)

    return m_apply, mt_apply


def _embed_point(x, y, s):
    """The embedding point at the solution: z = (x, y - s, 1), whose Pi is
    u = (x, y, 1) (Moreau: y and s are complementary)."""
    return torch.cat([x, y - s, torch.ones(1, dtype=x.dtype,
                                           device=x.device)])


@dataclasses.dataclass
class _Spec:
    """What the Function needs besides its tensor inputs: the layout, the
    solve's parameters, the mode, LSQR's settings, how to rebuild A from
    its leaves, whether A is dense and, for a batch, how its A splits
    into lanes (:class:`_LaneA`)."""
    cone: ConeLayout
    param: SolverParam
    mode: str
    lsqr_iters: int
    lsqr_rtol: Any
    rebuild: Callable
    dense: bool
    stats: dict
    lanes: Any = None

    def operator(self, leaves):
        return self.rebuild(list(leaves))

    def _setup(self, c, b, x, y, leaves):
        """DPi's data at the embedding point of (x, y) and M's appliers,
        on the problem in the iterate dtype."""
        dt = x.dtype
        a_op = pin_dtype(_as_op(self.operator(leaves)), dt)
        c, b = c.to(dt), b.to(dt)
        z = _embed_point(x, y, b - a_op.matvec(x))
        dp = dproj_at(self.cone, c.shape[0], b.shape[0], z)
        return (dp, *_m_ops(dp, c, a_op, b))

    def _lsqr(self, matvec, rmatvec, rhs):
        w, steps = _lsqr(matvec, rmatvec, rhs, self.lsqr_iters,
                         _rtol(self.lsqr_rtol, rhs.dtype))
        self.stats["lsqr_steps"] = steps
        return w

    def vjp(self, c, b, x, y, leaves, x_bar, y_bar):
        """(c_bar, b_bar, leaf cotangents) for the cotangents of x, y."""
        dp, m_apply, mt_apply = self._setup(c, b, x, y, leaves)
        n, m = c.shape[0], b.shape[0]
        u_x, u_y, u_t = dp.u[:n], dp.u[n:n + m], dp.u[-1]
        x_bar, y_bar = x_bar.to(x.dtype), y_bar.to(x.dtype)
        u_bar = torch.cat([x_bar, y_bar,
                           (-(u_x @ x_bar) - (u_y @ y_bar)).reshape(1)])
        # solve M' w = DPi' u_bar (min-norm least squares: M z = 0)
        w = self._lsqr(mt_apply, m_apply, dp.apply_t(u_bar))
        w_x, w_y, w_t = w[:n], w[n:n + m], w[-1]
        c_bar = -(w_x * u_t - w_t * u_x)
        b_bar = -(w_y * u_t - w_t * u_y)
        return (c_bar.to(c.dtype), b_bar.to(b.dtype),
                self._a_cotangent(leaves, u_x, u_y, w_x, w_y))

    def _a_cotangent(self, leaves, u_x, u_y, w_x, w_y):
        """-grad over A's leaves of w_x . A'u_y - w_y . A u_x."""
        if not leaves:                  # a sparse A: no leaf takes one
            return []
        if self.dense:
            (a,) = leaves
            return [-(torch.outer(u_y, w_x) - torch.outer(w_y, u_x)).to(
                a.dtype)]
        with torch.enable_grad():
            ls = [t.detach().requires_grad_(True) for t in leaves]
            op = self.operator(ls)
            dt = op.dtype or u_x.dtype
            val = w_x.to(dt) @ op.rmatvec(u_y.to(dt)) \
                - w_y.to(dt) @ op.matvec(u_x.to(dt))
            grads = torch.autograd.grad(val, ls, allow_unused=True)
        return [torch.zeros_like(t) if g is None else -g
                for t, g in zip(leaves, grads)]

    def jvp(self, c, b, x, y, leaves, dc, db, dleaves):
        """(dx, dy) for the tangents of c, b and A's leaves."""
        dp, m_apply, mt_apply = self._setup(c, b, x, y, leaves)
        n, m = c.shape[0], b.shape[0]
        u_x, u_y, u_t = dp.u[:n], dp.u[n:n + m], dp.u[-1]
        dt = x.dtype
        dc = torch.zeros_like(u_x) if dc is None else dc.to(dt)
        db = torch.zeros_like(u_y) if db is None else db.to(dt)
        dat_uy = torch.zeros_like(u_x)
        da_ux = torch.zeros_like(u_y)
        if any(t is not None for t in dleaves):
            tangents = tuple(torch.zeros_like(t) if d is None else d
                             for t, d in zip(leaves, dleaves))
            if self.dense:
                (da,) = tangents
                dat_uy, da_ux = u_y @ da.to(dt), da.to(dt) @ u_x
            else:
                def h_fn(*ls):
                    op = _as_op(self.operator(ls))
                    return (op.rmatvec(u_y.to(op.dtype or dt)),
                            op.matvec(u_x.to(op.dtype or dt)))

                _, (dat_uy, da_ux) = torch.func.jvp(h_fn, tuple(leaves),
                                                    tangents)
                dat_uy, da_ux = dat_uy.to(dt), da_ux.to(dt)
        g = torch.cat([dat_uy + dc * u_t, -da_ux + db * u_t,
                       (-(dc @ u_x) - (db @ u_y)).reshape(1)])
        # M dz = -g (min-norm least squares)
        du = dp.apply(self._lsqr(m_apply, mt_apply, -g))
        # x = u_x / u_tau at tau = 1: dx = du_x - x du_tau
        return du[:n] - x * du[-1], du[n:n + m] - y * du[-1]


def _as_op(a) -> LinOp:
    return a if isinstance(a, LinOp) else DenseOp(a)


@contextlib.contextmanager
def _outside_torch_func():
    """A context in which the rule computes on plain tensors; it yields
    ``plain``, which strips torch.func's wrappers from a tensor (None
    passes). Under ``torch.func.jvp`` (or ``torch.func.grad``) the rule
    sees its saved tensors and tangents wrapped at the transform's level,
    and every operation it ran would wrap its result too; a wrapper has
    no storage for a kernel to read. The rule's arithmetic is
    once-differentiable, so it runs on the plain tensors with the
    transforms' interpreter stack set aside, and returns plain results,
    which the transform takes as the tangents (or cotangents) of its
    level.

    This is the one place that touches torch.func's private internals
    (``torch._C._functorch.get_unwrapped``, ``is_functorch_wrapped_tensor``
    and ``torch._functorch.pyfunctorch.temporarily_clear_interpreter_stack``),
    checked on torch 2.11 (CUDA 12.8) and 2.13 (CPU); a torch that moves
    them fails ``test_rules_see_plain_tensors``."""
    from torch._C._functorch import (get_unwrapped,
                                     is_functorch_wrapped_tensor)
    from torch._functorch.pyfunctorch import \
        temporarily_clear_interpreter_stack

    def plain(t):
        while t is not None and is_functorch_wrapped_tensor(t):
            t = get_unwrapped(t)
        return t

    with temporarily_clear_interpreter_stack(), full_f32_matmul():
        yield plain


class _DiffSolve(torch.autograd.Function):
    """(c, b, A's leaves) -> (x, y) of one solve, with the implicit rule
    of the spec's mode: ``backward`` for 'vjp', ``jvp`` for 'jvp'."""

    @staticmethod
    def forward(spec, c, b, *leaves):
        res = solve_jit(c, spec.operator(leaves), b, spec.cone, spec.param)
        return res.x, res.y

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec, c, b, *leaves = inputs
        ctx.spec = spec
        saved = (c, b, *output, *leaves)
        if spec.mode == "vjp":
            ctx.save_for_backward(*saved)
        else:
            ctx.save_for_forward(*saved)

    @staticmethod
    @once_differentiable
    def backward(ctx, x_bar, y_bar):
        spec = ctx.spec
        if spec.mode != "vjp":
            raise RuntimeError("make_differentiable_solver(mode='jvp') "
                               "defines forward mode only; build the "
                               "solver with mode='vjp' for gradients")
        with _outside_torch_func() as plain:
            c, b, x, y, *leaves = (plain(t) for t in ctx.saved_tensors)
            c_bar, b_bar, a_bars = spec.vjp(c, b, x, y, leaves,
                                            plain(x_bar), plain(y_bar))
        return (None, c_bar, b_bar, *a_bars)

    @staticmethod
    def jvp(ctx, _spec_t, dc, db, *dleaves):
        spec = ctx.spec
        if spec.mode != "jvp":
            raise RuntimeError("make_differentiable_solver(mode='vjp') "
                               "defines reverse mode only; build the "
                               "solver with mode='jvp' for forward-mode "
                               "tangents")
        with _outside_torch_func() as plain:
            c, b, x, y, *leaves = (plain(t) for t in ctx.saved_tensors)
            return spec.jvp(c, b, x, y, leaves, plain(dc), plain(db),
                            [plain(t) for t in dleaves])


class _DiffSolveBatch(torch.autograd.Function):
    """(c, b, A's leaves) -> (x, y) of a lockstep batch (``solve_batch``;
    with ``kernel='mega'`` the forward runs on the batched megakernel), c
    and b (B, ...) or shared by every lane, A's leaves as ``spec.lanes``
    (:class:`_LaneA`) states them; the rule runs each lane's
    single-solve rule (:class:`_Spec`) on that lane's leaves and sums a
    shared input's cotangents over the lanes: the port's form of the JAX
    package's ``jax.vmap(jax.grad(...))``."""

    @staticmethod
    def forward(spec, c, b, *leaves):
        lanes = _lanes(c, b, spec.lanes)
        res = solve_batch_jit(_expand(c, lanes, 1),
                              spec.lanes.batch(leaves, lanes),
                              _expand(b, lanes, 1), spec.cone, spec.param)
        return res.x, res.y

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec, c, b, *leaves = inputs
        ctx.spec = spec
        saved = (c, b, *output, *leaves)
        if spec.mode == "vjp":
            ctx.save_for_backward(*saved)
        else:
            ctx.save_for_forward(*saved)

    @staticmethod
    @once_differentiable
    def backward(ctx, x_bar, y_bar):
        spec = ctx.spec
        if spec.mode != "vjp":
            return _DiffSolve.backward(ctx, x_bar, y_bar)
        with _outside_torch_func() as plain:
            c, b, x, y, *leaves = (plain(t) for t in ctx.saved_tensors)
            x_bar, y_bar = plain(x_bar), plain(y_bar)
            steps, bars = [], []
            for i in range(x.shape[0]):
                lane = spec.lanes.spec(spec, i)
                bars.append(lane.vjp(
                    _lane(c, i, 1), _lane(b, i, 1), x[i], y[i],
                    spec.lanes.lane(leaves, i), x_bar[i], y_bar[i]))
                steps.append(spec.stats["lsqr_steps"])
            spec.stats["lsqr_steps"] = steps
            a_bars = [_gather([bar[2][j] for bar in bars], ref)
                      for j, ref in enumerate(leaves)]
            return (None, _gather([bar[0] for bar in bars], c),
                    _gather([bar[1] for bar in bars], b), *a_bars)

    @staticmethod
    def jvp(ctx, _spec_t, dc, db, *dleaves):
        spec = ctx.spec
        if spec.mode != "jvp":
            return _DiffSolve.jvp(ctx, _spec_t, dc, db, *dleaves)
        with _outside_torch_func() as plain:
            c, b, x, y, *leaves = (plain(t) for t in ctx.saved_tensors)
            dc, db = plain(dc), plain(db)
            dleaves = [plain(t) for t in dleaves]
            steps, outs = [], []
            for i in range(x.shape[0]):
                lane = spec.lanes.spec(spec, i)
                outs.append(lane.jvp(
                    _lane(c, i, 1), _lane(b, i, 1), x[i], y[i],
                    spec.lanes.lane(leaves, i), _lane(dc, i, 1),
                    _lane(db, i, 1), spec.lanes.lane(dleaves, i)))
                steps.append(spec.stats["lsqr_steps"])
            spec.stats["lsqr_steps"] = steps
            return (torch.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]))


class _LaneA:
    """How a batch's A enters :class:`_DiffSolveBatch`: its floating
    tensors are the Function's inputs (``leaves``), lane-leading or shared
    by every lane; ``batch(leaves, lanes)`` is the operator the forward
    solves, ``lane(leaves, i)`` lane i's leaves and ``spec(spec, i)`` the
    single-solve rule of lane i (its rebuild)."""

    def __init__(self, a):
        self.dense = isinstance(a, torch.Tensor)
        if self.dense:
            self.leaves = [a]
            self.shared = a.dim() == 2
        elif isinstance(a, BatchedOp):
            self.shared = False
            self.every = a.leaves
            self.floating = [j for j, t in enumerate(a.leaves)
                             if t.is_floating_point()]
            self.leaves = [a.leaves[j] for j in self.floating]
            self.op = a
        else:
            self.shared = True
            self.leaves, self.rebuild = _flatten(a)
            self.op = a

    def _merge(self, every, leaves):
        out = list(every)
        for j, t in zip(self.floating, leaves):
            out[j] = t
        return out

    def batch(self, leaves, lanes: int) -> Any:
        if self.dense:
            return _expand(leaves[0], lanes, 2)
        if self.shared:
            return BatchedOp.shared(self.rebuild(list(leaves)), lanes)
        return self.op.with_leaves(self._merge(self.every, leaves))

    def lane(self, leaves, i: int):
        if self.shared:
            return list(leaves)
        return [None if t is None else t[i] for t in leaves]

    def spec(self, spec, i: int):
        if self.dense or self.shared:
            return spec
        if not self.floating:          # a sparse batch: no leaf to rebuild
            lane_op = self.op.lane(i)
            return dataclasses.replace(spec, rebuild=lambda ls: lane_op)
        every = [t[i] for t in self.every]
        return dataclasses.replace(
            spec, rebuild=lambda ls: self.op.lane_of(self._merge(every, ls)))


def _lanes(c, b, lanes_a) -> int:
    """The batch's lane count, from whichever input has a lane
    dimension."""
    if not lanes_a.shared:
        return lanes_a.op.batch if not lanes_a.dense \
            else lanes_a.leaves[0].shape[0]
    for t in (c, b):
        if t.dim() == 2:
            return t.shape[0]
    raise ValueError("a batch needs a (B, n) c, a (B, m) b or a batched A "
                     "((B, m, n), BatchedDenseOp or BatchedOp)")


def _expand(t, lanes, rank):
    """``t`` with its lane dimension: a shared input of per-lane ``rank``
    expanded (no copy)."""
    return t if t.dim() == rank + 1 else t.expand(lanes, *t.shape)


def _lane(t, i, rank):
    """Lane ``i`` of an input of per-lane ``rank``; a shared input (None
    too) is every lane's."""
    if t is None or t.dim() == rank:
        return t
    return t[i]


def _gather(per_lane, ref):
    """The cotangent of input ``ref`` from its lanes' cotangents: stacked
    for a batched input, summed over the lanes for a shared one."""
    out = torch.stack(per_lane)
    return out.to(ref.dtype) if out.dim() == ref.dim() \
        else out.sum(dim=0).to(ref.dtype)


class DifferentiableSolver:
    """``solver(c, a, b) -> (x, y)``, differentiable through the
    optimality conditions (see :func:`make_differentiable_solver`).
    ``stats['lsqr_steps']`` holds the LSQR steps of the last backward or
    forward-mode call (a list, one per lane, for a batch)."""

    def __init__(self, cone, param, mode, lsqr_iters, lsqr_rtol):
        self.cone = resolve_auto_methods(cone, param)
        self.param = param
        self.mode = mode
        self.lsqr_iters = int(lsqr_iters)
        self.lsqr_rtol = lsqr_rtol
        self.stats = {}

    def __call__(self, c, a, b):
        if _is_batch(c, a, b):
            return self._batch(c, a, b)
        leaves, rebuild = _flatten(a)
        dense = isinstance(a, torch.Tensor) or isinstance(a, DenseOp)
        if isinstance(a, DenseOp):
            # the dense A's one leaf is the matrix; the closed form
            # applies to it
            leaves, rebuild = [a.a], (lambda ls: DenseOp(ls[0]))
        spec = _Spec(self.cone, self.param, self.mode, self.lsqr_iters,
                     self.lsqr_rtol, rebuild, dense, self.stats)
        return _DiffSolve.apply(spec, c, b, *leaves)

    def _batch(self, c, a, b):
        """A lockstep batch: c (B, n) or (n,), b (B, m) or (m,), A (B, m,
        n) or (m, n) dense, a :class:`BatchedOp` (the counterpart of
        ``jax.vmap(solver)`` over a stacked pytree) or a structured LinOp
        shared by every lane (``jax.vmap(solver, in_axes=(0, None, 0))``),
        at least one with lanes; x (B, n), y (B, m)."""
        if isinstance(a, (DenseOp, BatchedDenseOp)):
            a = a.a
        lanes_a = _LaneA(a)
        spec = _Spec(self.cone, self.param, self.mode, self.lsqr_iters,
                     self.lsqr_rtol,
                     (lambda ls: DenseOp(ls[0])) if lanes_a.dense
                     else getattr(lanes_a, "rebuild", None),
                     lanes_a.dense, self.stats, lanes_a)
        return _DiffSolveBatch.apply(spec, c, b, *lanes_a.leaves)


def _is_batch(c, a, b) -> bool:
    """Whether the inputs carry a lane dimension: a (B, n) c, a (B, m) b,
    a (B, m, n) A or a batch operator."""
    return (c.dim() == 2 or b.dim() == 2
            or isinstance(a, (BatchedDenseOp, BatchedOp))
            or (isinstance(a, torch.Tensor) and a.dim() == 3))


def make_differentiable_solver(cone: ConeLayout,
                               param: SolverParam = SolverParam(),
                               mode: str = "vjp",
                               lsqr_iters: int = 1000,
                               lsqr_rtol=None) -> DifferentiableSolver:
    """Return ``fn(c, a, b) -> (x, y)`` differentiable through the
    optimality conditions. ``c`` and ``b`` are tensors; ``a`` is a dense
    (m, n) tensor or any LinOp (blocked-ELL, stacked, diagonal,
    matrix-free), whose cotangent or tangent lives in its own floating
    tensors (a ``BlockedEllOp``'s ``blocks`` and ``blocks_t`` each take
    their pass's half: combine as ``blocks + transpose(blocks_t)`` when
    updating one underlying A; a ``CustomOp``'s ``params``). A batch
    takes a (B, n) c or (B, m) b with a (B, m, n) A, a ``BatchedOp``
    (each lane's cotangent on its own tensors) or one operator shared by
    the lanes (its cotangent the lanes' sum). The solve
    runs where the data lies (``solve_jit``; it never raises: check
    convergence yourself when it matters), and so does the rule.

    ``mode='vjp'`` defines the reverse-mode rule (``torch.autograd.grad``
    through losses of x, y); ``mode='jvp'`` the forward-mode rule
    (``torch.func.jvp``, ``torch.autograd.forward_ad``). Both solve the
    singular system with matrix-free LSQR of at most ``lsqr_iters``
    steps; ``lsqr_rtol=None`` resolves per dtype (1e-12 in f64, 30 eps
    in f32; :func:`_rtol`)."""
    if mode not in ("vjp", "jvp"):
        raise ValueError(f"unknown mode {mode!r} (want 'vjp' or 'jvp')")
    return DifferentiableSolver(cone, param, mode, lsqr_iters, lsqr_rtol)
