"""Lockstep batched solves: B lanes of one cone layout and one parameter
set, each its own conic program, iterated together.

The JAX package gets this module from ``jax.vmap(solve_jit)``: its lanes
iterate in lockstep inside one ``lax.while_loop`` that runs until every
lane has stopped, and a lane that has stopped keeps its carry, so its
status, iteration count and solution are those of its own solve. The
port writes that out, because ``torch.vmap`` cannot trace a loop whose
trip count depends on the data:

* every iterate has a leading lane dimension: on the pdhg engine two
  flat tensors, u (B, n + 2m + 1) holding (x, y, s, tau) and v
  (B, n + m + 1) holding (vn, vm, kappa) (:class:`_Layout`), on the direct
  engine (B, n + m + 1); each lane's scalars (tau, kappa, the dots, the
  norms) are (B, 1) tensors, its status (B,) int32 and its criteria
  (B, 5), all on the device;
* the products are per lane (:class:`BatchedDenseOp`: two ``torch.bmm``,
  in full f32; :class:`BatchedOp` for structured lanes), and the cone
  projections take the B x count blocks of a factor in one call (one
  launch of kernel B for exp and pow, of kernel J for 'jacobi');
* the loop runs ``check_period`` updates of every lane, one check, and
  keeps each lane's new carry only where that lane was still running
  (``torch.where`` on the lane mask); one host read per check tells it
  whether any lane is still RUNNING and under its cap. Lanes are not
  compacted: a stopped lane still costs its share of every product;
* the Halpern weights, the restart epochs and the artificial restart are
  per-lane device tensors, so lanes restart at different checks;
* on the card a pdhg batch without exp, pow, PSD or custom factors (and
  without a ``CustomOp`` or ``SparseOp`` in its operator) runs each
  check period as one CUDA graph (:class:`_Period`); the check and its
  host read stay eager;
* ``method='direct'`` runs the dense direct engine lane by lane on a
  dense batch, the indirect engine (:class:`IndirectSolveBatch`, each
  lane's CG) on any other;
* ``kernel='mega'`` (and ``'auto'`` on the card) runs every lane's whole
  solve in one launch of the megakernel instead
  (``megakernel.solve_mega_batch``): each lane iterates and stops on its
  own, as the JAX package's Pallas kernel does under ``jax.vmap``.

The single-solve functions of ``conic.py`` and ``direct.py`` keep their
1-D arithmetic; what this module shares with them leaves that arithmetic
as it is. :func:`solve_batch_jit` is the entry; ``parallel/batch.py``
wraps it as ``solve_batch`` with chunking.
"""

import dataclasses
from typing import Optional

import torch

from totsu_tpu_torch.solver import cone as cones
from totsu_tpu_torch.solver.cone import ConeLayout, resolve_auto_methods
from totsu_tpu_torch.solver.conic import (ResumeState, SolveResult,
                                          _EPOCH_KEYS, _as_tensor, _log_due,
                                          _mega_choice,
                                          _resolve_fast_profile, _tensors)
from totsu_tpu_torch.solver.direct import cg_settings
from totsu_tpu_torch.solver.operator import (
    BatchedDenseOp, BatchedOp, BatchedSparseOp, BlockedEllOp, DenseOp, DiagOp,
    HStackOp, LinOp, ScaledOp, VStackOp, ZeroOp, as_data, full_f32_matmul)
from totsu_tpu_torch.solver.params import (SolverParam, SolverStatus,
                                           effective_eps_inf)

_RUNNING = int(SolverStatus.RUNNING)
_EXCESS = int(SolverStatus.EXCESS_ITER)


def as_batched_op(a, device=None) -> LinOp:
    """A (B, m, n) tensor or array, a :class:`BatchedDenseOp` (or one
    row-sharded over a mesh, ``parallel.sharded.RowShardedOp``) or a
    :class:`BatchedOp` of structured lanes, as the batch's operator. A
    structured operator without a lane axis raises ``ValueError``, as
    ``jax.vmap`` refuses a leaf without the batch's leading size."""
    if isinstance(a, (BatchedDenseOp, BatchedOp)) or _sharded(a):
        return a
    if isinstance(a, LinOp):
        raise ValueError(
            f"a batch needs lane-leading operators: {type(a).__name__} has "
            "no lane axis (stack the lanes with BatchedOp.stack)")
    a = as_data(a, device, "A")
    if a.dim() != 3:
        raise ValueError(f"a batch needs A as (B, m, n), got "
                         f"{tuple(a.shape)}")
    return BatchedDenseOp(a)


def _sharded(a) -> bool:
    """Whether ``a`` is a batch whose rows are split over a mesh: its
    products run collectives."""
    from totsu_tpu_torch.parallel.sharded import RowShardedOp
    return isinstance(a, RowShardedOp) \
        and isinstance(a.local, BatchedDenseOp)


def _vdot(x, y):
    """Each lane's dot product of (B, k) tensors, as (B, 1)."""
    return torch.bmm(x.unsqueeze(1), y.unsqueeze(2)).squeeze(2)


def _norm(x):
    """Each lane's 2-norm of a (B, k) tensor, as (B, 1)."""
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _sel(mask, new, old):
    """``new`` in the lanes where the (B,) ``mask`` holds, else ``old``:
    tensors with a leading lane dimension, or tuples of them."""
    if isinstance(new, tuple):
        return tuple(_sel(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask.view(-1, *([1] * (new.dim() - 1))), new, old)


#: capture the pdhg batch's check period as a CUDA graph where it can be
#: captured (:func:`_graphable`); False runs every update eagerly (for
#: timing one against the other)
CUDA_GRAPHS = True


def _graphable(cone: ConeLayout, device, a_op: Optional[LinOp] = None
               ) -> bool:
    """Whether a pdhg batch's check period runs as one CUDA graph: on a
    CUDA device, with only zero, R+, SOC and RSOC factors and (given
    ``a_op``) an operator whose products read nothing on the host
    (:func:`_graph_safe`). Those projections are PyTorch operations
    without a host read; an exp, pow, PSD or custom factor keeps the eager
    loop, so that kernels B and J launch from their wrappers (which count
    each launch) and an 'eigh' projection may read the host."""
    return (CUDA_GRAPHS and torch.device(device).type == "cuda"
            and (a_op is None or _graph_safe(a_op))
            and all(f.kind in (cones.ZERO, cones.RPOS, cones.SOC,
                               cones.RSOC) for f in cone.factors))


def _graph_safe(a_op: LinOp) -> bool:
    """A dense batch, or a structured one whose every operator is a
    dense, blocked-ELL, diagonal, zero, scaled or stacked one. A
    ``CustomOp`` runs user code, which may read the host, and a
    ``SparseOp``'s SpMV is not bitwise on repeat (PERF.md §6): both keep
    the eager loop."""
    if isinstance(a_op, BatchedDenseOp):
        return True
    if not isinstance(a_op, BatchedOp):
        return False

    def safe(op):
        if isinstance(op, (VStackOp, HStackOp)):
            return all(safe(o) for o in op.ops)
        if isinstance(op, ScaledOp):
            return safe(op.op)
        return isinstance(op, (BlockedEllOp, DenseOp, DiagOp, ZeroOp))

    return not isinstance(a_op, BatchedSparseOp) and safe(a_op.template)


class _Period:
    """A check period's updates, ``body(*inputs) -> tuple``, a function of
    lane-leading tensors. Eager, or with ``graph`` captured at its first
    call as one CUDA graph on the inputs' device and replayed at every
    later call: the host then queues one graph a check where it queued
    some 40 to 90 launches an iteration (the loop is bound by them, PERF.md
    §5). The replay runs the captured kernels on copies of the inputs
    and returns the same output tensors each time, which the loops
    consume (through their lane selects) before the next call."""

    def __init__(self, body, graph: bool):
        self.body = body
        self.graph = graph
        self._g = None

    def __call__(self, *inputs):
        if not self.graph:
            return self.body(*inputs)
        if self._g is None:
            self._capture(inputs)
        for held, t in zip(self._in, inputs):
            held.copy_(t)
        self._g.replay()
        return self._out

    def _capture(self, inputs):
        self._in = [t.clone() for t in inputs]
        with torch.cuda.device(self._in[0].device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.body(*self._in)   # warm-up: cuBLAS's handles
            torch.cuda.current_stream().wait_stream(side)
            self._g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._g):
                self._out = self.body(*self._in)


def _running(status, k, cap):
    return (status == _RUNNING) & (k < cap)


def _codes(device):
    return {s: torch.tensor(int(s), dtype=torch.int32, device=device)
            for s in SolverStatus}


def _precond(a_op: LinOp, c, b, cone: ConeLayout, eps_zero: float):
    """Each lane's diagonal preconditioners (``conic._precond``)."""
    col_a = a_op.col_abssum()
    row_a = a_op.row_abssum()
    sum_cb = c.abs().sum(dim=-1, keepdim=True) \
        + b.abs().sum(dim=-1, keepdim=True)

    def inv(x):
        return 1.0 / torch.clamp(x, min=eps_zero)

    tau_x = col_a + c.abs()
    tau_y = row_a + b.abs()
    dp_tau = (inv(tau_x), cone.group_min(inv(tau_y)),
              cone.group_min(torch.ones_like(b)), inv(sum_cb))
    dp_sigma = (inv(tau_x), inv(tau_y + 1.0), inv(sum_cb))
    return dp_tau, dp_sigma


class _Layout:
    """The pdhg iterate of a batch as two flat tensors: u (B, n + 2m + 1)
    holding (x, y, s, tau) and v (B, n + m + 1) holding (vn, vm, kappa),
    so that every elementwise step over the whole iterate (the step with
    the preconditioners, the reflection, the Halpern average, the lane
    selects) is one launch, where a segment tuple takes one per segment.
    Each segment is a view; the arithmetic per element is the segment
    tuple's (``conic._make_update``)."""

    def __init__(self, n: int, m: int):
        self.n, self.m = n, m

    def u(self, u):
        n, m = self.n, self.m
        return u[:, :n], u[:, n:n + m], u[:, n + m:n + 2 * m], u[:, -1:]

    def v(self, v):
        n, m = self.n, self.m
        return v[:, :n], v[:, n:n + m], v[:, -1:]

    def sq_dist(self, tu, u, tv, v):
        """||T(z) - z||^2 per lane, summed segment by segment as the JAX
        package sums its pytree's leaves."""
        pairs = list(zip(self.u(tu), self.u(u))) \
            + list(zip(self.v(tv), self.v(v)))
        return sum(torch.sum((x - y) ** 2, dim=-1, keepdim=True)
                   for x, y in pairs)


def _make_update(mv_op, c_it, b_it, dp_tau, dp_sigma, cone, relax,
                 lay: _Layout):
    """Every lane's Pock-Chambolle step (``conic._make_update``) on the
    flat iterate; ``dp_tau`` and ``dp_sigma`` flat too."""
    n, m = lay.n, lay.m

    def update(u_old, v_old):
        vn, vm, v1 = lay.v(v_old)
        a_vn, at_vm = mv_op.dual_matvec(vn, vm)
        # K^T v, then the step on the whole of u in one pass
        r = torch.cat([-at_vm - c_it * v1, a_vn - b_it * v1, -vm,
                       _vdot(c_it, vn) + _vdot(b_it, vm)], dim=-1)
        w = u_old - dp_tau * r
        # dual cone on the y block, primal cone on the s block, tau >= 0;
        # the x block is not projected
        u = torch.cat([w[:, :n], cone.project(w[:, n:n + m], dual=True),
                       cone.project(w[:, n + m:n + 2 * m], dual=False),
                       torch.clamp(w[:, -1:], min=0.0)], dim=-1)
        ru = u_old - 2.0 * u
        rx, ry, rs, rt = lay.u(ru)
        a_ux, at_uy = mv_op.dual_matvec(rx, ry)
        kv = torch.cat([at_uy + c_it * rt, -a_ux - rs + b_it * rt,
                        -_vdot(c_it, rx) - _vdot(b_it, ry)], dim=-1)
        v = v_old - dp_sigma * kv
        # projection onto the F* cone: kappa := min(kappa, 0)
        v[:, -1:].clamp_(max=0.0)
        if relax != 1.0:
            u = u_old + relax * (u - u_old)
            v = v_old + relax * (v - v_old)
        return u, v

    return update


def _make_check(a_op, c, b, norm_b, norm_c, sb, sc, eps_acc, eps_inf,
                eps_zero, lay=None):
    """Every lane's termination criteria (``conic._make_check``):
    ``check(u, v, k, cap) -> (status (B,), crits (B, 5))`` with ``u`` the
    segment tuple (x, y, s, tau) or a flat pdhg iterate (split by
    ``lay``), ``k`` and ``cap`` the lanes' (B,) iteration counts and caps
    (``v`` unused)."""
    st = _codes(c.device)
    inf = torch.tensor(float("inf"), dtype=c.dtype, device=c.device)

    def check(u, _v, k, cap):
        ux, uy_, us, val_tau = lay.u(u) if lay is not None else u
        if sb is not None:
            ux, uy_, us = ux * sb, uy_ * sc, us * sb
        ax, aty = a_op.dual_matvec(ux, uy_)
        cx = _vdot(c, ux)
        by = _vdot(b, uy_)
        tau_pos = val_tau > eps_zero
        inv_tau = 1.0 / torch.where(tau_pos, val_tau, 1.0)
        p = ax * inv_tau + us * inv_tau - b
        d = c + aty * inv_tau
        g_x = cx * inv_tau
        g_y = by * inv_tau
        g = g_x + g_y
        cri_pri = _norm(p) / (1.0 + norm_b)
        cri_dual = _norm(d) / (1.0 + norm_c)
        cri_gap = g.abs() / (1.0 + g_x.abs() + g_y.abs())
        conv = tau_pos & (cri_pri <= eps_acc) & (cri_dual <= eps_acc) \
            & (cri_gap <= eps_acc)
        m_cx = -cx
        m_by = -by
        cri_unbdd = torch.where(m_cx > eps_zero,
                                _norm(ax + us) * norm_c / m_cx, inf)
        cri_infeas = torch.where(m_by > eps_zero,
                                 _norm(aty) * norm_b / m_by, inf)
        unbdd = (~tau_pos) & (cri_unbdd <= eps_inf)
        infeas = (~tau_pos) & (cri_infeas <= eps_inf)
        last = torch.where(k >= cap, st[SolverStatus.EXCESS_ITER],
                           st[SolverStatus.RUNNING])
        status = torch.where(
            conv[:, 0], st[SolverStatus.CONVERGED],
            torch.where(unbdd[:, 0], st[SolverStatus.UNBOUNDED],
                        torch.where(infeas[:, 0],
                                    st[SolverStatus.INFEASIBLE], last)))
        crits = torch.cat([cri_pri, cri_dual, cri_gap, cri_unbdd,
                           cri_infeas], dim=-1)
        return status, crits

    return check


def _print_lines(run, k, values, fmt, check_period, log_period):
    """The JAX package's progress line for every lane that ran this check
    and is due (its vmapped ``debug.print`` prints once per lane)."""
    if log_period <= 0:
        return
    run, k, values = run.tolist(), k.tolist(), values.tolist()
    for r, ki, vals in zip(run, k, values):
        if r and _log_due(ki, check_period, log_period):
            print(fmt(ki, *vals))


def _pdhg_line(k, p, d, g, ub, inf):
    return (f"{k}: pri_dual_gap {p:.2e} {d:.2e} {g:.2e} "
            f"unbdd_infeas {ub:.2e} {inf:.2e}")


def _run_plain(update, check, u, v, k, cap, status, crits, check_period,
               lay=None, aux=None, log_period=0, graph=False, carry=None):
    """The plain loop (``conic._run_plain``) over lanes: ``u``, ``v`` are
    lane-leading tensors (the flat pdhg iterate, or the direct engine's
    u and v); ``lay`` is unused; ``graph`` runs each check period as a
    CUDA graph (:class:`_Period`); ``carry`` (the indirect engine's
    :class:`IndirectSolveBatch`) holds state of its own that a stopped
    lane keeps, bracketed by ``begin(run)`` and ``end()`` each period."""

    def body(un, vn):
        for _ in range(check_period):
            un, vn = update(un, vn)
        return un, vn

    period = _Period(body, graph)
    run = _running(status, k, cap)
    while bool(run.any()):
        if carry is not None:
            carry.begin(run)
        un, vn = period(u, v)
        kn = k + check_period
        st, cr = check(un, vn, kn, cap)
        if carry is not None:
            carry.end()
        u, v = _sel(run, un, u), _sel(run, vn, v)
        k = torch.where(run, kn, k)
        status = torch.where(run, st, status)
        crits = _sel(run, cr, crits)
        _print_lines(run, k, crits, _pdhg_line, check_period, log_period)
        run = _running(status, k, cap)
    return u, v, k, status, crits, {}


def _weights(ke, check_period: int, dtype):
    """Each lane's Halpern weights for the next ``check_period`` steps:
    (w, 1 - w), each (B, check_period), with w = (ke + 1) / (ke + 2) in the
    iterate dtype, as the JAX package's device loop computes them."""
    kef = (ke[:, None] + torch.arange(check_period, device=ke.device)
           ).to(dtype)
    w = (kef + 1.0) / (kef + 2.0)
    return w, 1.0 - w


def _artificial(ke, k, check_period: int, dtype):
    """Each lane's epoch has run past 36% of all its iterations (at least
    four check periods), compared in the iterate dtype."""
    return ke.to(dtype) >= torch.clamp(0.36 * k.to(dtype),
                                       min=4.0 * check_period)


def _halpern_step(t, i, a, w, wa):
    return w * (2.0 * t - i) + wa * a


def _run_halpern(update, check, u0, v0, k, cap, status, crits,
                 check_period, lay, aux=None, log_period=0, graph=False):
    """Restarted reflected Halpern (``conic._run_halpern``) over lanes, on
    the flat iterate of ``lay``; ``graph`` as in :func:`_run_plain`."""

    def body(un, vn, au, av, w, wa):
        for j in range(check_period):
            tu, tv = update(un, vn)
            wj, waj = w[:, j:j + 1], wa[:, j:j + 1]
            un = _halpern_step(tu, un, au, wj, waj)
            vn = _halpern_step(tv, vn, av, wj, waj)
        return un, vn

    period = _Period(body, graph)
    dtype = u0.dtype
    lanes = k.shape[0]
    u, v, ru, rv = u0, v0, u0, v0
    if aux is not None:
        au, av, ke = aux["au"], aux["av"], aux["ke"]
        fp_rst, fp_last = aux["fp_rst"], aux["fp_last"]
    else:
        au, av = u0, v0
        ke = torch.zeros_like(k)
        fp_rst = fp_last = torch.full((lanes, 1), float("inf"), dtype=dtype,
                                      device=k.device)
    run = _running(status, k, cap)
    while bool(run.any()):
        un, vn = period(u, v, au, av, *_weights(ke, check_period, dtype))
        ken = ke + check_period
        kn = k + check_period
        tu, tv = update(un, vn)
        fp = torch.sqrt(lay.sq_dist(tu, un, tv, vn))
        st, cr = check(tu, tv, kn, cap)
        restart = ((fp <= 0.2 * fp_rst)
                   | ((fp <= 0.8 * fp_rst) & (fp > fp_last)))[:, 0] \
            | _artificial(ken, kn, check_period, dtype)
        take = restart | (st != _RUNNING)
        # the raw carry an uninterrupted loop continues from, apart from
        # the point the result takes on exit
        run_ru, run_rv = _sel(restart, tu, un), _sel(restart, tv, vn)
        run_u, run_v = _sel(take, tu, un), _sel(take, tv, vn)
        run_au, run_av = _sel(restart, tu, au), _sel(restart, tv, av)
        u, v = _sel(run, run_u, u), _sel(run, run_v, v)
        ru, rv = _sel(run, run_ru, ru), _sel(run, run_rv, rv)
        au, av = _sel(run, run_au, au), _sel(run, run_av, av)
        ke = torch.where(run, torch.where(restart, 0, ken), ke)
        fp_rst = _sel(run, _sel(restart, fp, fp_rst), fp_rst)
        fp_last = _sel(run, fp, fp_last)
        k = torch.where(run, kn, k)
        status = torch.where(run, st, status)
        crits = _sel(run, cr, crits)
        _print_lines(run, k, torch.cat([fp, restart[:, None].to(dtype)], -1),
                     lambda ki, f, r: f"{ki}: fp_res {f:.2e} "
                     f"(restart={bool(r)})", check_period, log_period)
        run = _running(status, k, cap)
    return u, v, k, status, crits, {
        "au": au, "av": av, "ke": ke, "fp_rst": fp_rst, "fp_last": fp_last,
        "ru": ru, "rv": rv}


def _run_restarted(update, check, u0, v0, k, cap, status, crits,
                   check_period, lay, aux=None, log_period=0, graph=False):
    """PDLP-style restarted averaging (``conic._run_restarted``) over
    lanes, on the flat iterate of ``lay``: each lane picks its own
    candidate and restarts on its own; ``graph`` as in
    :func:`_run_plain`."""

    def body(un, vn, sun, svn):
        for _ in range(check_period):
            un, vn = update(un, vn)
            sun = sun + un
            svn = svn + vn
        return un, vn, sun, svn

    period = _Period(body, graph)
    dtype = u0.dtype
    lanes = k.shape[0]
    u, v, ru, rv = u0, v0, u0, v0
    zeros = torch.zeros_like

    if aux is not None:
        su, sv, ke = aux["su"], aux["sv"], aux["ke"]
        res_rst, res_last = aux["res_rst"], aux["res_last"]
    else:
        su, sv = zeros(u0), zeros(v0)
        ke = torch.zeros_like(k)
        res_rst = res_last = torch.full((lanes, 1), float("inf"),
                                        dtype=dtype, device=k.device)
    run = _running(status, k, cap)
    while bool(run.any()):
        un, vn, sun, svn = period(u, v, su, sv)
        kn = k + check_period
        ken = ke + check_period
        count = ken.to(dtype)[:, None]
        ub = sun / count
        vb = svn / count
        st_c, cr_c = check(un, vn, kn, cap)
        st_a, cr_a = check(ub, vb, kn, cap)
        res_c = cr_c[:, :3].amax(dim=-1, keepdim=True)
        res_a = cr_a[:, :3].amax(dim=-1, keepdim=True)
        use_avg = (res_a < res_c)[:, 0]
        res = torch.minimum(res_a, res_c)
        restart = ((res <= 0.2 * res_rst)
                   | ((res <= 0.8 * res_rst) & (res > res_last)))[:, 0] \
            | _artificial(ken, kn, check_period, dtype)
        st = torch.where(use_avg, st_a, st_c)
        cr = _sel(use_avg, cr_a, cr_c)
        cand_u, cand_v = _sel(use_avg, ub, un), _sel(use_avg, vb, vn)
        take = restart | (st != _RUNNING)
        run_ru, run_rv = _sel(restart, cand_u, un), _sel(restart, cand_v, vn)
        run_u, run_v = _sel(take, cand_u, un), _sel(take, cand_v, vn)
        u, v = _sel(run, run_u, u), _sel(run, run_v, v)
        ru, rv = _sel(run, run_ru, ru), _sel(run, run_rv, rv)
        su = _sel(run, _sel(restart, zeros(sun), sun), su)
        sv = _sel(run, _sel(restart, zeros(svn), svn), sv)
        ke = torch.where(run, torch.where(restart, 0, ken), ke)
        res_rst = _sel(run, _sel(restart, res, res_rst), res_rst)
        res_last = _sel(run, res, res_last)
        k = torch.where(run, kn, k)
        status = torch.where(run, st, status)
        crits = _sel(run, cr, crits)
        _print_lines(run, k, torch.cat([res, restart[:, None].to(dtype)], -1),
                     lambda ki, r, rs: f"{ki}: res {r:.2e} "
                     f"(restart={bool(rs)})", check_period, log_period)
        run = _running(status, k, cap)
    return u, v, k, status, crits, {
        "su": su, "sv": sv, "ke": ke, "res_rst": res_rst,
        "res_last": res_last, "ru": ru, "rv": rv}


_LOOPS = {"": _run_plain, "halpern": _run_halpern,
          "restart": _run_restarted}


def _terminal(status):
    return (status != _EXCESS) & (status != _RUNNING)


def _unpack_resume(state, engine: str, accel: str, lanes: int, device,
                   dtype):
    """(u0, v0, k0, aux) from a batched :class:`ResumeState` (its ``k``
    a (B,) tensor): another engine raises, another accel starts a fresh
    epoch, and tensors that are not the batch's device and dtype raise
    (integer counters excepted)."""
    if not isinstance(state, ResumeState) or not isinstance(state.k,
                                                            torch.Tensor):
        raise ValueError("a batch resumes from the ResumeState of a batch "
                         "(its k is a (B,) tensor)")
    if state.engine != engine:
        raise ValueError(f"resume_state was produced by the {state.engine} "
                         f"engine and cannot resume method='{engine}'")
    if tuple(state.k.shape) != (lanes,):
        raise ValueError(f"resume_state holds {tuple(state.k.shape)} lanes, "
                         f"the batch {lanes}")
    aux = state.aux if state.accel == accel and state.aux else None
    for t in _tensors((state.u, state.v, aux)):
        if t.device != device or (t.is_floating_point() and t.dtype != dtype):
            raise ValueError(f"resume_state holds a {t.dtype} tensor on "
                             f"{t.device}; the batch runs in {dtype} on "
                             f"{device}")
    return state.u, state.v, state.k.to(device), aux


def _initial(check, u0, v0, k, cap, aux, seeded: bool, lanes, dtype,
             device):
    """Each lane's (status, crits) to start from (``conic.initial_status``):
    a checkpoint's saved criteria (EXCESS_ITER becomes RUNNING, a terminal
    lane stays terminal), a seeded start checked at the seed, else
    RUNNING."""
    if aux is not None and "crits" in aux:
        saved = aux["status"]
        return torch.where(saved == _EXCESS, _RUNNING, saved).to(
            torch.int32), aux["crits"]
    if seeded:
        return check(u0, v0, k, cap)
    return (torch.full((lanes,), _RUNNING, dtype=torch.int32, device=device),
            torch.full((lanes, 5), float("inf"), dtype=dtype, device=device))


def _scale_back(x, y, tau, eps_zero, sb, sc, equil_d, equil_e):
    """The solution from the iterate (``conic._finish``), per lane."""
    pos = tau > eps_zero
    scale = torch.where(pos, 1.0 / torch.where(pos, tau, 1.0), 1.0)
    x, y = x * scale, y * scale
    if sb is not None:
        x, y = x * sb, y * sc
    if equil_e is not None:
        x, y = x * equil_e, y * equil_d
    return x, y


def _result(x, y, k, k_start, status, crits, state,
            route: str = "loop") -> SolveResult:
    """The batch's result; ``diag["route"]`` says what ran the lanes:
    'loop' (this module's lockstep loop) or 'mega' (the megakernel)."""
    return SolveResult(
        x=x, y=y, status=status, iters=k - k_start, cri_pri=crits[:, 0],
        cri_dual=crits[:, 1], cri_gap=crits[:, 2], cri_unbdd=crits[:, 3],
        cri_infeas=crits[:, 4], state=state, diag={"route": route})


def _checkpoint(param, engine, u, v, k, aux, status, crits):
    """The batch's ResumeState (with ``return_state``). ``aux`` None means
    no exportable epoch (the megakernel): an empty dict, as a single
    solve's megakernel checkpoint."""
    if not param.return_state:
        return None
    aux = {} if aux is None else {**aux, "crits": crits, "status": status}
    return ResumeState(u=u, v=v, k=k, aux=aux, engine=engine,
                       accel=param.accel)


def _setup(c, a_op, b, cone, param, default_norm: bool):
    """Shared per-lane setup: the iterate dtype, A pinned to it (an
    expanded A stays expanded), Ruiz, the norms and the normalization."""
    dtype = torch.promote_types(c.dtype, b.dtype)
    c, b = c.to(dtype), b.to(dtype)
    if a_op.dtype != dtype:
        a_op = a_op.astype(dtype)
    lanes = a_op.batch
    m, n = a_op.shape
    if tuple(c.shape) != (lanes, n) or tuple(b.shape) != (lanes, m):
        raise ValueError(f"a batch of {lanes} lanes of A {m}x{n} needs c "
                         f"({lanes}, {n}) and b ({lanes}, {m}); got "
                         f"{tuple(c.shape)} and {tuple(b.shape)}")
    if cone.dim != m:
        raise ValueError(f"cone dim {cone.dim} != m {m}")
    equil_d = equil_e = None
    if param.equil_iters is not None and param.equil_iters > 0:
        from totsu_tpu_torch.solver.scaling import ruiz_equilibrate_op
        a_op, b, c, equil_d, equil_e = ruiz_equilibrate_op(
            a_op, b, c, cone, iters=param.equil_iters)
    norm_b, norm_c = _norm(b), _norm(c)
    do_norm = bool(param.normalize) if param.normalize is not None \
        else default_norm
    if do_norm:
        sb = torch.where(norm_b > param.eps_zero, norm_b, 1.0)
        sc = torch.where(norm_c > param.eps_zero, norm_c, 1.0)
        b_it, c_it = b / sb, c / sc
    else:
        sb = sc = None
        b_it, c_it = b, c
    return (dtype, c, a_op, b, equil_d, equil_e, norm_b, norm_c, sb, sc,
            b_it, c_it)


def _seed(warm_start, dtype, device, equil, s):
    """A warm start's part in the iterate's scaled space, or None."""
    if warm_start is None:
        return None
    w = torch.as_tensor(warm_start, dtype=dtype, device=device)
    if equil is not None:
        w = w / equil
    return w if s is None else w / s


def _solve_pdhg(c, a_op, b, cone, param, warm_start, resume_state):
    (dtype, c, a_op, b, equil_d, equil_e, norm_b, norm_c, sb, sc, b_it,
     c_it) = _setup(c, a_op, b, cone, param, False)
    device, lanes = a_op.device, a_op.batch
    m, n = a_op.shape
    mv_op = precond_op = a_op
    if param.matvec_dtype is not None:
        mv_op = a_op.astype(param.matvec_dtype)
        precond_op = mv_op.astype(dtype)
    eps_zero = param.eps_zero
    check_period = max(1, param.check_period)
    lay = _Layout(n, m)
    dp_tau, dp_sigma = (torch.cat(d, dim=-1) for d in _precond(
        precond_op, c_it, b_it, cone, eps_zero))
    # the cold start: u = 0 except tau = 1, v = 0
    u0 = torch.zeros(lanes, n + 2 * m + 1, dtype=dtype, device=device)
    u0[:, -1] = 1.0
    v0 = torch.zeros(lanes, n + m + 1, dtype=dtype, device=device)
    k_start = torch.zeros(lanes, dtype=torch.int64, device=device)
    resume_aux = None
    if resume_state is not None:
        u0, v0, k_start, resume_aux = _unpack_resume(
            resume_state, "pdhg", param.accel, lanes, device, dtype)
        taken = (u0, v0)
        if resume_aux is not None \
                and not _EPOCH_KEYS[param.accel] <= set(resume_aux):
            resume_aux = None
        if resume_aux is not None and "ru" in resume_aux:
            # the raw carry, except in a terminal lane, which keeps its
            # taken pair (the point its saved criteria describe)
            term = _terminal(resume_aux["status"])
            u0 = _sel(term, u0, resume_aux["ru"])
            v0 = _sel(term, v0, resume_aux["rv"])
    elif warm_start is not None:
        ws_x, ws_y = warm_start
        ux0, uy0, _, tau0 = lay.u(u0)
        if ws_x is not None:
            ux0 = _seed(ws_x, dtype, device, equil_e, sb)
        if ws_y is not None:
            uy0 = cone.project(_seed(ws_y, dtype, device, equil_d, sc),
                               dual=True)
        # the slack seeded at Pi_K(b - A x0), so that a warm start at the
        # solution is a fixed point
        s_seed = cone.project(b_it - a_op.matvec(ux0), dual=False)
        u0 = torch.cat([ux0, uy0, s_seed, tau0], dim=-1)
    relax = float(param.relax)
    if param.accel == "halpern" and relax != 1.0:
        raise ValueError("accel='halpern' requires relax=1.0")
    seeded = warm_start is not None or resume_state is not None
    if _mega_choice(param, a_op, cone, dtype):
        # as the single solve: a host-loop checkpoint seeds the kernel
        # from its taken pair, and the kernel checks every seeded start
        seed_u, seed_v = taken if resume_state is not None else (u0, v0)
        u, v, k, status, crits = _run_mega(
            a_op, c_it, b_it, c, b, dp_tau, dp_sigma, seed_u, seed_v, cone,
            param, lay, sb, sc, effective_eps_inf(param, dtype), relax,
            check_period, seeded)
        k = k_start + k
        ux, uy, _, tau = lay.u(u)
        x, y = _scale_back(ux, uy, tau, eps_zero, sb, sc, equil_d, equil_e)
        return _result(x, y, k, k_start, status, crits,
                       _checkpoint(param, "pdhg", u, v, k, None, status,
                                   crits), route="mega")
    cap = k_start + param.bounded_max_iter
    update = _make_update(mv_op, c_it, b_it, dp_tau, dp_sigma, cone, relax,
                          lay)
    check = _make_check(a_op, c, b, norm_b, norm_c, sb, sc, param.eps_acc,
                        effective_eps_inf(param, dtype), eps_zero, lay)
    status, crits = _initial(check, u0, v0, k_start, cap, resume_aux,
                             seeded, lanes, dtype, device)
    u, v, k, status, crits, aux = _LOOPS[param.accel](
        update, check, u0, v0, k_start, cap, status, crits,
        check_period, lay, aux=resume_aux, log_period=param.log_period,
        # a row-sharded A's collectives are counted on the host, and
        # gloo's cannot be captured: its batch stays eager
        graph=_graphable(cone, device, a_op))
    ux, uy, _, tau = lay.u(u)
    x, y = _scale_back(ux, uy, tau, eps_zero, sb, sc, equil_d, equil_e)
    return _result(x, y, k, k_start, status, crits,
                   _checkpoint(param, "pdhg", u, v, k, aux, status, crits))


def _run_mega(a_op, c_it, b_it, c, b, dp_tau, dp_sigma, u0, v0, cone,
              param, lay: _Layout, sb, sc, eps_inf, relax, check_period,
              seeded):
    """Every lane's whole solve on the megakernel
    (``megakernel.solve_mega_batch``; its plain version on CPU tensors)
    from the flat iterate and preconditioners of ``lay``: ``(u, v, k,
    status, crits)``, u and v flat, k each lane's iterations of this
    call. An A expanded from one matrix stays one matrix."""
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    a = a_op.a
    if not (a.stride(0) == 0 and a[0].is_contiguous()):
        a = a.contiguous()

    def lane_scalar(t):
        return None if t is None else t[:, 0].contiguous()

    (ux, uy, us, ut), (vn, vm, kap), k, status, crits = mk.solve_mega_batch(
        a, c_it.contiguous(), b_it.contiguous(), c.contiguous(),
        b.contiguous(), _split(lay.u(dp_tau)), _split(lay.v(dp_sigma)),
        _split(lay.u(u0)), _split(lay.v(v0)), cone, eps_acc=param.eps_acc,
        eps_inf=eps_inf, eps_zero=float(param.eps_zero),
        max_iter=param.bounded_max_iter, check_period=check_period,
        relax=relax, accel=param.accel, sb=lane_scalar(sb),
        sc=lane_scalar(sc), check_at_start=seeded)
    u = torch.cat([ux, uy, us, ut[:, None]], dim=-1)
    v = torch.cat([vn, vm, kap[:, None]], dim=-1)
    return u, v, k, status, crits


def _split(parts):
    """Segments of a flat iterate as the kernel takes them: each vector
    segment contiguous, the trailing (B, 1) scalar as (B,)."""
    return tuple(t.contiguous() for t in parts[:-1]) \
        + (parts[-1][:, 0].contiguous(),)


# ---- the direct engine, lane by lane (``solver/direct.py``): the dense
# cached solve, or the indirect mode's CG

def newton_schulz_inverse(spd):
    """Each lane's Newton-Schulz inverse of a (B, n, n) SPD batch
    (``direct.newton_schulz_inverse``): a lane steps while its residual
    falls, stays above 1e-7 and its steps are under 100, and keeps its
    last step; one host read per step. Returns (X, steps (B,))."""
    n = spd.shape[-1]
    eye = torch.eye(n, dtype=spd.dtype, device=spd.device)
    x = eye / torch.linalg.matrix_norm(spd)[:, None, None]
    res = torch.linalg.matrix_norm(eye - torch.matmul(x, spd))
    res_prev = torch.full_like(res, float("inf"))
    steps = torch.zeros(spd.shape[0], dtype=torch.int64, device=spd.device)

    def active():
        return (steps < 100) & (res < res_prev) & (res > 1e-7)

    act = active()
    while bool(act.any()):
        xn = torch.matmul(x, 2.0 * eye - torch.matmul(spd, x))
        resn = torch.linalg.matrix_norm(eye - torch.matmul(xn, spd))
        x = _sel(act, xn, x)
        res, res_prev = torch.where(act, resn, res), \
            torch.where(act, res, res_prev)
        steps = steps + act.to(steps.dtype)
        act = active()
    return x, steps


@dataclasses.dataclass(frozen=True)
class SpdSolveBatch:
    """Each lane's cached solve of M = I + A^T A (``direct.SpdSolve``):
    lower Cholesky factors in f64, Newton-Schulz inverses with two
    refinement steps per solve otherwise."""
    factor: torch.Tensor
    cholesky: bool
    ns_steps: torch.Tensor

    @property
    def refine_steps(self) -> int:
        return 0 if self.cholesky else 2

    def aux(self) -> dict:
        key = "chol_c" if self.cholesky else "prec"
        return {key: self.factor, "ns_steps": self.ns_steps,
                "refine_steps": self.refine_steps}

    @classmethod
    def from_aux(cls, aux: dict, dtype) -> Optional["SpdSolveBatch"]:
        cholesky = dtype == torch.float64
        factor = aux.get("chol_c" if cholesky else "prec")
        if factor is None:
            return None
        return cls(factor, cholesky, aux["ns_steps"])

    @classmethod
    def build(cls, amat) -> "SpdSolveBatch":
        n = amat.shape[-1]
        spd = torch.eye(n, dtype=amat.dtype, device=amat.device) \
            + torch.matmul(amat.transpose(1, 2), amat)
        if amat.dtype == torch.float64:
            return cls(torch.linalg.cholesky(spd), True,
                       torch.zeros(amat.shape[0], dtype=torch.int64,
                                   device=amat.device))
        prec, steps = newton_schulz_inverse(spd)
        return cls(prec, False, steps)

    def apply_inv(self, r):
        if self.cholesky:
            return torch.cholesky_solve(r.unsqueeze(-1),
                                        self.factor).squeeze(-1)
        return torch.bmm(self.factor, r.unsqueeze(-1)).squeeze(-1)


def _cg(apply_fn, rhs, x0, rel_tol: float, max_cg: int, inv_diag=None,
        active=None):
    """Each lane's warm-started (Jacobi-preconditioned with ``inv_diag``)
    conjugate gradient (``direct._cg``), as a vmapped ``lax.while_loop``
    runs it: a lane steps while its own ``rr > tol2`` and its steps are
    under ``max_cg`` (and it is in ``active``, a (B,) mask, when given); a
    lane that has stopped keeps x, r, p and rz exactly; the loop runs
    until no lane steps, one host read per step. Returns ``(x, rel2 (B,),
    lockstep steps)``."""
    r = rhs - apply_fn(x0)
    den = torch.clamp(_vdot(rhs, rhs), min=torch.finfo(rhs.dtype).tiny)
    tol2 = (rel_tol ** 2) * den

    def prec(res):
        return res if inv_diag is None else res * inv_diag

    x = x0
    z = prec(r)
    p = z
    rz = _vdot(r, z)
    rr = rz if inv_diag is None else _vdot(r, r)
    steps = torch.zeros(x0.shape[0], dtype=torch.int64, device=x0.device)

    def stepping():
        act = (rr > tol2)[:, 0] & (steps < max_cg)
        return act if active is None else act & active

    act = stepping()
    lock = 0
    while bool(act.any()):
        ap = apply_fn(p)
        alpha = rz / _vdot(p, ap)
        xn = x + alpha * p
        rn = r - alpha * ap
        zn = prec(rn)
        rz_new = _vdot(rn, zn)
        rr_new = rz_new if inv_diag is None else _vdot(rn, rn)
        pn = zn + (rz_new / rz) * p
        x, r, p, rz, rr = _sel(act, (xn, rn, pn, rz_new, rr_new),
                               (x, r, p, rz, rr))
        steps = steps + act.to(steps.dtype)
        lock += 1
        act = stepping()
    return x, (rr / den)[:, 0], lock


class IndirectSolveBatch:
    """Each lane's indirect-mode M-solve (``direct.IndirectSolve``):
    warm-started CG on I + A_i^T A_i for a structured batch, the settings
    of the single solve (``direct.cg_settings``: ``cg_tol``, ``max_cg =
    min(n, 500)``, the tighter border solve, Jacobi PCG from each lane's
    ``col_sqsum`` under 'auto' or 'jacobi', plain CG for a ``CustomOp``).
    ``ws = (z1 (B, n), worst_rel2 (B,))`` is each lane's warm start and
    worst residual. The loops bracket each check period with
    :meth:`begin` and :meth:`end`: a lane outside the period's running
    mask takes no CG step and keeps its ``ws``, as a stopped lane of the
    JAX package's vmapped loop keeps its carry. ``steps`` counts lockstep
    CG steps (each one product of every lane), ``solves`` the batched
    resolvents."""

    def __init__(self, a_op, n: int, dtype, device, param: SolverParam,
                 lanes: int, ws=None):
        self.a_op = a_op
        cg_settings(self, a_op, n, dtype, param)
        self.ws = ws if ws is not None else (
            torch.zeros(lanes, n, dtype=dtype, device=device),
            torch.zeros(lanes, dtype=dtype, device=device))
        self.run = self._ws0 = None
        self.steps = self.solves = self.setup_steps = 0

    def begin(self, run):
        self.run, self._ws0 = run, self.ws

    def end(self):
        self.ws = _sel(self.run, self.ws, self._ws0)
        self.run = self._ws0 = None

    def spd_apply(self, z):
        return z + self.a_op.rmatvec(self.a_op.matvec(z))

    def m_solve(self, r1, r2):
        xw, worst = self.ws
        z1, rel2, steps = _cg(self.spd_apply, r1 - self.a_op.rmatvec(r2), xw,
                              self.cg_tol, self.max_cg, self.inv_diag,
                              self.run)
        self.ws = (z1, torch.maximum(worst, rel2))
        self.steps += steps
        self.solves += 1
        return z1, r2 + self.a_op.matvec(z1)

    def setup_solve(self, r1, r2):
        z1, _, self.setup_steps = _cg(
            self.spd_apply, r1 - self.a_op.rmatvec(r2), torch.zeros_like(r1),
            self.setup_tol, self.setup_max, self.inv_diag)
        return z1, r2 + self.a_op.matvec(z1)

    def diag(self) -> dict:
        """Each lane's worst relative resolvent residual and the target,
        (B,) tensors, and the lockstep CG steps of this call's resolvents
        and of the border's solve."""
        worst = torch.sqrt(self.ws[1])
        return {"cg_worst_rel": worst,
                "cg_tol": torch.full_like(worst, self.cg_tol),
                "cg_steps": self.steps, "cg_solves": self.solves,
                "cg_setup_steps": self.setup_steps}


def _run_halpern_dr(t_map, pair, check, z0, k, cap, status, crits,
                    check_period, aux=None, carry=None):
    """Restarted Halpern on the DR variable (``direct._run_halpern_dr``)
    over lanes; ``carry`` as in :func:`_run_plain`."""
    dtype = z0.dtype
    lanes = k.shape[0]
    z = rz = z0
    if aux is not None:
        anchor, ke = aux["anchor"], aux["ke"]
        fp_rst, fp_last = aux["fp_rst"], aux["fp_last"]
    else:
        anchor, ke = z0, torch.zeros_like(k)
        fp_rst = fp_last = torch.full((lanes, 1), float("inf"), dtype=dtype,
                                      device=z0.device)
    run = _running(status, k, cap)
    while bool(run.any()):
        if carry is not None:
            carry.begin(run)
        w, wa = _weights(ke, check_period, dtype)
        zn = z
        for j in range(check_period):
            zn = _halpern_step(t_map(zn), zn, anchor, w[:, j:j + 1],
                               wa[:, j:j + 1])
        ken = ke + check_period
        kn = k + check_period
        tz = t_map(zn)
        if carry is not None:
            carry.end()
        fp = _norm(tz - zn)
        st, cr = check(*pair(tz), kn, cap)
        restart = ((fp <= 0.2 * fp_rst)
                   | ((fp <= 0.8 * fp_rst) & (fp > fp_last)))[:, 0] \
            | _artificial(ken, kn, check_period, dtype)
        take = restart | (st != _RUNNING)
        rz = _sel(run, _sel(restart, tz, zn), rz)
        z = _sel(run, _sel(take, tz, zn), z)
        anchor = _sel(run, _sel(restart, tz, anchor), anchor)
        ke = torch.where(run, torch.where(restart, 0, ken), ke)
        fp_rst = _sel(run, _sel(restart, fp, fp_rst), fp_rst)
        fp_last = _sel(run, fp, fp_last)
        k = torch.where(run, kn, k)
        status = torch.where(run, st, status)
        crits = _sel(run, cr, crits)
        run = _running(status, k, cap)
    return z, k, status, crits, {"anchor": anchor, "ke": ke,
                                 "fp_rst": fp_rst, "fp_last": fp_last,
                                 "z": rz}


def _solve_direct(c, a_op, b, cone, param, warm_start, resume_state):
    (dtype, c, a_op, b, equil_d, equil_e, norm_b, norm_c, sb, sc, b_it,
     c_it) = _setup(c, a_op, b, cone, param, True)
    device, lanes = a_op.device, a_op.batch
    m, n = a_op.shape
    eps_zero = param.eps_zero
    check_period = max(1, param.check_period)
    if param.accel == "halpern":
        if param.relax != 1.0:
            raise ValueError("accel='halpern' requires relax=1.0")
        relax = 1.0
    elif param.accel:
        raise ValueError(
            f"accel {param.accel!r} is not supported by the direct engine"
            " ('halpern' is)")
    else:
        relax = float(param.relax) if param.relax != 1.0 else 1.5
    nm1 = n + m + 1
    u0 = torch.zeros(lanes, nm1, dtype=dtype, device=device)
    u0[:, -1] = 1.0
    v0 = u0.clone()
    k_start = torch.zeros(lanes, dtype=torch.int64, device=device)
    resume_aux = None
    if resume_state is not None:
        u0, v0, k_start, resume_aux = _unpack_resume(
            resume_state, "direct", param.accel, lanes, device, dtype)
    elif warm_start is not None:
        ws_x, ws_y = warm_start
        if ws_x is not None:
            u0[:, :n] = _seed(ws_x, dtype, device, equil_e, sb)
        if ws_y is not None:
            u0[:, n:n + m] = cone.project(
                _seed(ws_y, dtype, device, equil_d, sc), dual=True)
        v0 = torch.zeros(lanes, nm1, dtype=dtype, device=device)
        v0[:, n:n + m] = cone.project(b_it - a_op.matvec(u0[:, :n]),
                                      dual=False)
    aux_c = resume_aux if resume_aux is not None else {}
    indirect = None
    if isinstance(a_op, BatchedDenseOp):
        cache = SpdSolveBatch.from_aux(aux_c, dtype) \
            or SpdSolveBatch.build(a_op.a)

        def spd_solve(rhs):
            z = cache.apply_inv(rhs)
            for _ in range(cache.refine_steps):
                z = z + cache.apply_inv(rhs - z
                                        - a_op.rmatvec(a_op.matvec(z)))
            return z

        def m_solve(r1, r2):
            z1 = spd_solve(r1 - a_op.rmatvec(r2))
            return z1, r2 + a_op.matvec(z1)

        setup_solve = m_solve
        aux = cache.aux()
    else:
        # any other operator: the indirect mode, as the JAX package takes
        # it for every operator but a DenseOp
        indirect = IndirectSolveBatch(a_op, n, dtype, device, param, lanes,
                                      ws=aux_c.get("ws"))
        m_solve, setup_solve = indirect.m_solve, indirect.setup_solve
        aux = {}
    h = torch.cat([c_it, b_it], dim=-1)
    if "gh" in aux_c:
        gh, denom = aux_c["gh"], aux_c["denom"]
    else:
        gh = torch.cat(setup_solve(c_it, b_it), dim=-1)
        denom = 1.0 + _vdot(h, gh)

    def iq_solve(w):
        wtau = w[:, -1:]
        rhs = w[:, :n + m] - wtau * h
        t = torch.cat(m_solve(rhs[:, :n], rhs[:, n:]), dim=-1)
        z = t - gh * (_vdot(h, t) / denom)
        return torch.cat([z, wtau + _vdot(h, z)], dim=-1)

    def proj_c(w):
        return torch.cat([w[:, :n], cone.project(w[:, n:n + m], dual=True),
                          torch.clamp(w[:, -1:], min=0.0)], dim=-1)

    def update(u, v):
        ut = iq_solve(u + v)
        ut = u + relax * (ut - u)
        u_new = proj_c(ut - v)
        return u_new, v - ut + u_new

    def t_map(z):
        pu = proj_c(z)
        return iq_solve(2.0 * pu - z) - pu + z

    def pair(z):
        pu = proj_c(z)
        return pu, pu - z

    cap = k_start + param.bounded_max_iter
    pdhg_check = _make_check(a_op, c, b, norm_b, norm_c, sb, sc,
                             param.eps_acc, effective_eps_inf(param, dtype),
                             eps_zero)

    def check(u, v, k, cp):
        return pdhg_check((u[:, :n], u[:, n:n + m], v[:, n:n + m],
                           u[:, -1:]), None, k, cp)

    status, crits = _initial(
        check, u0, v0, k_start, cap, resume_aux,
        warm_start is not None or resume_state is not None, lanes, dtype,
        device)
    aux.update(gh=gh, denom=denom)
    if param.accel == "halpern":
        hal_keys = {"anchor", "ke", "fp_rst", "fp_last", "z"}
        hal_resume = resume_aux if resume_aux is not None \
            and hal_keys <= set(resume_aux) else None
        z0 = hal_resume["z"] if hal_resume is not None \
            else iq_solve(u0 + v0) - v0
        z, k, status, crits, hal_aux = _run_halpern_dr(
            t_map, pair, check, z0, k_start, cap, status, crits,
            check_period, aux=hal_resume, carry=indirect)
        u, v = pair(z)
        if hal_resume is not None:
            # a terminal lane keeps the pair its checkpoint presented
            term = _terminal(hal_resume["status"])
            u, v = _sel(term, u0, u), _sel(term, v0, v)
        aux.update(hal_aux)
    else:
        u, v, k, status, crits, _ = _run_plain(
            update, check, u0, v0, k_start, cap, status, crits,
            check_period, carry=indirect)
    x, y = _scale_back(u[:, :n], u[:, n:n + m], u[:, -1:], eps_zero, sb, sc,
                       equil_d, equil_e)
    if indirect is not None:
        aux["ws"] = indirect.ws
    res = _result(x, y, k, k_start, status, crits,
                  _checkpoint(param, "direct", u, v, k, aux, status, crits))
    if indirect is not None:
        res.diag.update(indirect.diag())
    return res


def solve_batch_jit(c, a, b, cone: ConeLayout,
                    param: SolverParam = SolverParam(), warm_start=None,
                    resume_state=None, *, device=None) -> SolveResult:
    """The lockstep solve of B lanes, each ``solve_jit`` of its own
    (c, A, b): ``c`` (B, n), ``a`` (B, m, n) (a tensor, array or
    :class:`BatchedDenseOp`; an A expanded from one matrix is not
    copied; or one whose rows are split over a mesh's ``row`` axis, from
    ``parallel.solve_batch(mesh=)``), ``b`` (B, m); the layout and the
    parameters are shared.
    ``warm_start`` is (X (B, n) or None, Y (B, m) or None); a zero seed
    runs the seeded start (the slack seeded at Pi_K(b) and a check at the
    seed), as in the JAX package. Never raises on non-convergence: the
    result's ``status`` and ``iters`` are (B,) tensors, x (B, n), y (B, m)
    and each criterion (B,), all on A's device; ``state`` (with
    ``return_state``) is a :class:`ResumeState` whose ``k`` is (B,).

    Every option of ``solve_jit`` is honoured lane by lane or raises:
    ``profile='fast'`` and ``psd(method='auto')`` resolve on one lane's
    shapes, as inside ``jax.vmap``; ``kernel`` resolves as the single
    solve's (``conic._mega_choice``) on the batch: ``'mega'`` runs every
    lane on the megakernel in one launch (its plain version on CPU
    tensors) and raises outside its envelope (a dense f32 batch, not
    row-sharded, no ``matvec_dtype``, accel '' or 'halpern', zero/R+/SOC/
    RSOC/exp/pow cones, each lane's A within ``A_BUDGET_BYTES``);
    ``'auto'``, and the fast profile where it picks the megakernel, take
    it on the card inside that envelope without ``log_period``;
    ``log_period`` prints each lane's line on the host loop. The
    result's ``diag["route"]`` is 'mega' or 'loop'. The host policy of
    ``solve`` (auto-equilibration, the CG warning, polish) does not run,
    as in the JAX package's ``solve_batch``."""
    with full_f32_matmul():
        a_op = as_batched_op(a, device)
        cone = resolve_auto_methods(cone, param)
        row_sharding = a_op.sharding if _sharded(a_op) else None
        if param.profile == "fast":
            param = _resolve_fast_profile(param, a_op.lane(0), cone,
                                          row_sharding)
        elif param.profile != "reference":
            raise ValueError(f"unknown profile {param.profile!r}")
        if param.method not in ("pdhg", "direct"):
            raise ValueError(f"unknown method {param.method!r}")
        if param.accel not in ("", "halpern", "restart"):
            raise ValueError(f"unknown accel {param.accel!r}")
        if param.kernel not in ("", "auto", "mega"):
            raise ValueError(f"unknown kernel {param.kernel!r}")
        c = _as_tensor(c, a_op.device)
        b = _as_tensor(b, a_op.device)
        if param.method == "direct":
            if param.matvec_dtype is not None:
                raise ValueError("matvec_dtype is a pdhg-engine feature")
            if row_sharding is not None:
                raise ValueError(
                    "method='direct' does not honor a row-sharded batch "
                    "(mesh constraints are a pdhg-engine feature); use "
                    "method='pdhg', or a mesh with row=1")
            return _solve_direct(c, a_op, b, cone, param, warm_start,
                                 resume_state)
        return _solve_pdhg(c, a_op, b, cone, param, warm_start,
                           resume_state)
