"""The solver core: homogeneous self-dual embedding + first-order iteration.

Port of ``totsu_tpu.solver.conic`` (dense pdhg engine). Solves

    minimize    c^T x
    subject to  A x + s = b,   s in K

via the homogeneous self-dual embedding matrix (never materialized)

    K_emb = [[ 0,    A^T, 0,  c ],
             [-A,    0,  -I,  b ],
             [-c^T, -b^T, 0,  0 ]]

iterated with the diagonally preconditioned Pock-Chambolle primal-dual
method. The iterate ``u`` is the segment tuple ``(x (n), y (m), s (m),
tau ())`` and the dual ``v`` is ``(vn (n), vm (m), kappa ())``, all on the
device of A.

The JAX ``lax.while_loop`` becomes a host loop: ``check_period`` updates,
one termination check, then one ``.item()``-style read of the status —
the loop's only host sync. ``kernel='mega'`` runs the whole loop instead
in one CUDA kernel launch (``ops/kernels/megakernel.py``).
``method='direct'`` hands the solve to the direct engine
(``solver/direct.py``); ``profile='fast'`` picks engine and knobs first
(:func:`_resolve_fast_profile`).
"""

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from totsu_tpu_torch.solver.cone import ConeLayout, RSOC, EXP, POW, PSD
from totsu_tpu_torch.solver.operator import LinOp, DenseOp, as_linop
from totsu_tpu_torch.solver.params import (SolverParam, SolverStatus,
                                           SolverError, effective_eps_inf)

_NOT_PORTED = "is not ported yet (ROADMAP §1 item {})"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} " + _NOT_PORTED.format(item))


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Solve output. ``status`` and ``iters`` are Python ints; ``x``/``y``
    (divided by tau on convergence) and the criteria are tensors on the
    device of A."""
    x: Any
    y: Any
    status: int
    iters: int
    cri_pri: Any
    cri_dual: Any
    cri_gap: Any
    cri_unbdd: Any
    cri_infeas: Any
    state: Any = None
    diag: Any = None

    @property
    def converged(self) -> bool:
        return self.status == SolverStatus.CONVERGED


def _emb_apply(a_op: LinOp, c, b, u):
    """K_emb @ u for u = (ux, uy, us, ut) (SelfDualEmbed::op)."""
    ux, uy, us, ut = u
    a_ux, at_uy = a_op.dual_matvec(ux, uy)
    vn = at_uy + c * ut
    vm = -a_ux - us + b * ut
    v1 = -torch.dot(c, ux) - torch.dot(b, uy)
    return (vn, vm, v1)


def _emb_rapply(a_op: LinOp, c, b, v):
    """K_emb^T @ v for v = (vn, vm, v1) (SelfDualEmbed::trans_op)."""
    vn, vm, v1 = v
    a_vn, at_vm = a_op.dual_matvec(vn, vm)
    ux = -at_vm - c * v1
    uy = a_vn - b * v1
    us = -vm
    ut = torch.dot(c, vn) + torch.dot(b, vm)
    return (ux, uy, us, ut)


def _precond(a_op: LinOp, c, b, cone: ConeLayout, eps_zero: float):
    """Diagonal preconditioners as segment tuples: dp_tau =
    1/colabssum(K_emb), dp_sigma = 1/rowabssum(K_emb), eps_zero-clamped,
    with per-cone-block min-grouping (SolverCore::calc_precond)."""
    m = b.shape[0]
    col_a = a_op.col_abssum()
    row_a = a_op.row_abssum()
    sum_cb = c.abs().sum() + b.abs().sum()

    def inv(x):
        return 1.0 / torch.clamp(x, min=eps_zero)

    tau_x = col_a + c.abs()
    tau_y = row_a + b.abs()
    ones = torch.ones(m, dtype=c.dtype, device=c.device)
    dp_tau = (inv(tau_x), cone.group_min(inv(tau_y)), cone.group_min(ones),
              inv(sum_cb))
    dp_sigma = (inv(tau_x), inv(tau_y + 1.0), inv(sum_cb))
    return dp_tau, dp_sigma


def _relaxed(old, new, relax: float):
    return tuple(o + relax * (nn - o) for o, nn in zip(old, new))


def _make_update(mv_op: LinOp, c_it, b_it, dp_tau, dp_sigma,
                 cone: ConeLayout, relax: float):
    """One Pock-Chambolle step (SolverCore::update_vecs), optionally
    over-relaxed; ``update(u, v) -> (u, v)``."""

    def update(u_old, v_old):
        r = _emb_rapply(mv_op, c_it, b_it, v_old)
        # dual cone on the y block, primal cone on the s block, tau >= 0;
        # the x block is not projected
        ux = u_old[0] - dp_tau[0] * r[0]
        uy = cone.project(u_old[1] - dp_tau[1] * r[1], dual=True)
        us = cone.project(u_old[2] - dp_tau[2] * r[2], dual=False)
        ut = torch.clamp(u_old[3] - dp_tau[3] * r[3], min=0.0)
        u = (ux, uy, us, ut)
        ru = tuple(o - 2.0 * nn for o, nn in zip(u_old, u))
        kv = _emb_apply(mv_op, c_it, b_it, ru)
        vn = v_old[0] - dp_sigma[0] * kv[0]
        vm = v_old[1] - dp_sigma[1] * kv[1]
        # projection onto the F* cone: kappa := min(kappa, 0)
        v1 = torch.clamp(v_old[2] - dp_sigma[2] * kv[2], max=0.0)
        v = (vn, vm, v1)
        if relax != 1.0:
            u = _relaxed(u_old, u, relax)
            v = _relaxed(v_old, v, relax)
        return u, v

    return update


def _make_check(a_op: LinOp, c, b, norm_b, norm_c, sb, sc, eps_acc: float,
                eps_inf: float, eps_zero: float, cap: int):
    """Termination criteria (criteria_conv + criteria_inf) evaluated on
    the un-normalized data; ``check(u, v, k) -> (status, crits)`` with
    ``status`` an int32 tensor and ``crits`` a (5,) tensor, both on the
    device (nothing is read to the host here)."""
    dtype = c.dtype
    inf = torch.tensor(float("inf"), dtype=dtype, device=c.device)

    def code(s):
        return torch.tensor(int(s), dtype=torch.int32, device=c.device)

    st = {s: code(s) for s in SolverStatus}

    def check(u, _v, k: int):
        ux, uy_, us, val_tau = u
        if sb is not None:
            ux, uy_, us = ux * sb, uy_ * sc, us * sb
        ax, aty = a_op.dual_matvec(ux, uy_)
        cx = torch.dot(c, ux)
        by = torch.dot(b, uy_)

        tau_pos = val_tau > eps_zero
        inv_tau = 1.0 / torch.where(tau_pos, val_tau, 1.0)

        p = ax * inv_tau + us * inv_tau - b
        d = c + aty * inv_tau
        g_x = cx * inv_tau
        g_y = by * inv_tau
        g = g_x + g_y
        cri_pri = torch.linalg.vector_norm(p) / (1.0 + norm_b)
        cri_dual = torch.linalg.vector_norm(d) / (1.0 + norm_c)
        cri_gap = g.abs() / (1.0 + g_x.abs() + g_y.abs())
        conv = tau_pos & (cri_pri <= eps_acc) & (cri_dual <= eps_acc) \
            & (cri_gap <= eps_acc)

        p_inf = ax + us
        m_cx = -cx
        m_by = -by
        cri_unbdd = torch.where(
            m_cx > eps_zero,
            torch.linalg.vector_norm(p_inf) * norm_c / m_cx, inf)
        cri_infeas = torch.where(
            m_by > eps_zero,
            torch.linalg.vector_norm(aty) * norm_b / m_by, inf)
        unbdd = (~tau_pos) & (cri_unbdd <= eps_inf)
        infeas = (~tau_pos) & (cri_infeas <= eps_inf)

        last = st[SolverStatus.EXCESS_ITER if k >= cap
                  else SolverStatus.RUNNING]
        status = torch.where(
            conv, st[SolverStatus.CONVERGED],
            torch.where(unbdd, st[SolverStatus.UNBOUNDED],
                        torch.where(infeas, st[SolverStatus.INFEASIBLE],
                                    last)))
        crits = torch.stack([cri_pri, cri_dual, cri_gap, cri_unbdd,
                             cri_infeas])
        return status, crits

    return check


def _run_plain(update, check, u, v, k: int, status: int, crits, cap: int,
               check_period: int):
    """The reference iteration: ``check_period`` updates, one check, one
    host read of the status, until a terminal status or the cap."""
    while status == SolverStatus.RUNNING and k < cap:
        for _ in range(check_period):
            u, v = update(u, v)
        k += check_period
        st, crits = check(u, v, k)
        status = int(st.item())
    return u, v, k, status, crits


def _sq_dist(a, b):
    return sum(torch.sum((x - y) ** 2) for x, y in zip(a, b))


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).replace("torch.", ""))


def _halpern_weights(ndt: np.dtype, ke: int):
    """(w, 1 - w) with w = (ke + 1) / (ke + 2), rounded to the iterate
    dtype ``ndt`` as the device loop of the JAX package computes them."""
    w = ndt.type(ke + 1) / ndt.type(ke + 2)
    return float(w), float(ndt.type(1.0) - w)


def _artificial_restart(ndt: np.dtype, ke: int, k: int,
                        check_period: int) -> bool:
    """The epoch has run past 36% of all iterations (at least four check
    periods): the int ``ke`` compared in the iterate dtype ``ndt``."""
    return bool(ndt.type(ke) >= max(ndt.type(0.36) * ndt.type(k),
                                    ndt.type(4.0 * check_period)))


def _run_halpern(update, check, u0, v0, k: int, status: int, crits,
                 cap: int, check_period: int):
    """Restarted reflected-Halpern PDHG (rHPDHG; Lu & Yang 2024):

        z_{k+1} = (k+1)/(k+2) * (2 T(z_k) - z_k) + 1/(k+2) * z_0,

    restarting the epoch from the projected point T(z) when the
    fixed-point residual ||T(z) - z|| decays sufficiently (x0.2), stalls
    after a necessary decay (x0.8), or the epoch exceeds 36% of all
    iterations; termination is evaluated at T(z). The restart decision is
    computed on the device in the iterate dtype and read to the host with
    the status in one transfer per check."""
    dtype = u0[0].dtype
    ndt = _np_dtype(dtype)
    u, v, au, av = u0, v0, u0, v0
    inf = torch.tensor(float("inf"), dtype=dtype, device=u0[0].device)
    fp_rst, fp_last = inf, inf
    ke = 0
    while status == SolverStatus.RUNNING and k < cap:
        for _ in range(check_period):
            tu, tv = update(u, v)
            w, wa = _halpern_weights(ndt, ke)
            u = tuple(w * (2.0 * t - i) + wa * a for t, i, a in zip(tu, u, au))
            v = tuple(w * (2.0 * t - i) + wa * a for t, i, a in zip(tv, v, av))
            ke += 1
        k += check_period
        tu, tv = update(u, v)
        fp = torch.sqrt(_sq_dist(tu, u) + _sq_dist(tv, v))
        st, crits = check(tu, tv, k)
        restart = (fp <= 0.2 * fp_rst) \
            | ((fp <= 0.8 * fp_rst) & (fp > fp_last)) \
            | _artificial_restart(ndt, ke, k, check_period)
        status, restart = (int(x) for x in
                           torch.stack([st, restart.to(torch.int32)]).tolist())
        if restart or status != SolverStatus.RUNNING:
            u, v = tu, tv
        if restart:
            au, av = tu, tv
            ke = 0
            fp_rst = fp
        fp_last = fp
    return u, v, k, status, crits


def _run_restarted(update, check, u0, v0, k: int, status: int, crits,
                   cap: int, check_period: int):
    """PDLP-style restarted averaging (Applegate et al. 2021, the scheme
    behind cuPDLP): the plain update, with the running average of the
    epoch's iterates. Each check evaluates the criteria at the current
    iterate and at the average and takes the one with the smaller
    residual (the largest of its three relative KKT criteria) as the
    candidate; the
    epoch restarts from the candidate on sufficient decay (x0.2 of the
    residual at the last restart), on necessary decay (x0.8) without
    progress since the last check, or past 36% of all iterations.
    Averages of iterates stay inside every cone, so the criteria keep
    their meaning there. The statuses of both points, the choice and the
    restart decision reach the host in one transfer per check."""
    dtype = u0[0].dtype
    ndt = _np_dtype(dtype)
    u, v = u0, v0

    def zeros(seg):
        return tuple(torch.zeros_like(x) for x in seg)

    su, sv = zeros(u0), zeros(v0)
    inf = torch.tensor(float("inf"), dtype=dtype, device=u0[0].device)
    res_rst, res_last = inf, inf
    ke = 0
    while status == SolverStatus.RUNNING and k < cap:
        for _ in range(check_period):
            u, v = update(u, v)
            su = tuple(s + x for s, x in zip(su, u))
            sv = tuple(s + x for s, x in zip(sv, v))
        k += check_period
        ke += check_period
        count = float(ndt.type(ke))
        ub = tuple(s / count for s in su)
        vb = tuple(s / count for s in sv)
        st_c, cr_c = check(u, v, k)
        st_a, cr_a = check(ub, vb, k)
        res_c = cr_c[:3].max()
        res_a = cr_a[:3].max()
        use_avg = res_a < res_c
        res = torch.minimum(res_a, res_c)
        restart = (res <= 0.2 * res_rst) \
            | ((res <= 0.8 * res_rst) & (res > res_last)) \
            | _artificial_restart(ndt, ke, k, check_period)
        st_c, st_a, use_avg, restart = (int(x) for x in torch.stack([
            st_c, st_a, use_avg.to(torch.int32),
            restart.to(torch.int32)]).tolist())
        status, crits = (st_a, cr_a) if use_avg else (st_c, cr_c)
        if (restart or status != SolverStatus.RUNNING) and use_avg:
            u, v = ub, vb
        if restart:
            su, sv = zeros(u0), zeros(v0)
            ke = 0
            res_rst = res
        res_last = res
    return u, v, k, status, crits


def run_loop(update, check, u0, v0, *, cap: int, check_period: int,
             accel: str, check_at_start: bool, dtype, device):
    """The pdhg loop shared by :func:`solve_jit` and the megakernel's plain
    version: ``(u, v, k, status, crits)`` after iterating from (u0, v0)."""
    if check_at_start:
        # an already-converged seed terminates at 0 iterations
        st, crits = check(u0, v0, 0)
        status = int(st.item())
    else:
        status = int(SolverStatus.RUNNING)
        crits = torch.full((5,), float("inf"), dtype=dtype, device=device)
    run = {"": _run_plain, "halpern": _run_halpern,
           "restart": _run_restarted}.get(accel)
    if run is None:
        raise ValueError(f"unknown accel {accel!r}")
    return run(update, check, u0, v0, 0, status, crits, cap, check_period)


def _check_supported(param: SolverParam, resume_state, row_sharding):
    """Raise for every feature of the JAX solve_jit this slice does not
    port, naming its ROADMAP item; never fall back silently. Runs after
    the fast profile is resolved."""
    if param.method not in ("pdhg", "direct"):
        raise ValueError(f"unknown method {param.method!r}")
    if param.accel not in ("", "halpern", "restart"):
        raise ValueError(f"unknown accel {param.accel!r}")
    if resume_state is not None:
        raise _not_ported("resume_state", "5")
    if param.return_state:
        raise _not_ported("return_state", "5")
    if row_sharding is not None:
        raise _not_ported("row_sharding", "14")
    if param.log_period > 0:
        raise _not_ported("log_period > 0", "9")


def _on_card(a_op: LinOp) -> bool:
    """Whether the solve runs on a CUDA device: the fast profile asks this
    where the JAX package asks whether it runs on a TPU."""
    return isinstance(a_op, DenseOp) and a_op.a.device.type == "cuda"


def _resolve_fast_profile(param: SolverParam, a_op: LinOp, cone: ConeLayout,
                          row_sharding=None) -> SolverParam:
    """Resolve ``profile='fast'`` into concrete parameters, field for
    field as the JAX package does: every knob still at its dataclass
    default gets the fast setting, explicitly set fields win.

    * small dense problems inside the megakernel's envelope, on the card,
      stay on pdhg with ``kernel='auto'`` (mega-first);
    * other dense problems with n <= 8192 go to the direct engine with
      ``accel='halpern'``;
    * structured operators go to the direct engine too (its indirect
      mode; ROADMAP item 10), PSD layouts excepted;
    * everything else: pdhg with ``accel='halpern'``, ``normalize`` and,
      for dense A, ``equil_iters=10``.

    A ``row_sharding`` keeps the solve on pdhg, the engine that honours
    mesh constraints. The crossovers (mega-first at n <= 300, n <= 200
    with RSOC blocks and never with exp/pow blocks; the direct engine up
    to n = 8192) are the JAX package's TPU measurements, unmeasured on the
    H100 (ROADMAP item 17)."""
    dense = isinstance(a_op, DenseOp)
    m, n = a_op.shape
    updates = {"profile": "reference"}
    if param.check_period == 1:
        updates["check_period"] = 20
    if param.kernel == "":
        updates["kernel"] = "auto"
    if any(f.kind in (EXP, POW) for f in cone.factors):
        mega_n_max = 0
    else:
        mega_n_max = 200 if any(f.kind == RSOC for f in cone.factors) \
            else 300
    mega_first = False
    if dense and param.method == "pdhg" and param.matvec_dtype is None \
            and param.relax == 1.0 and n <= mega_n_max \
            and param.log_period == 0:
        from totsu_tpu_torch.ops.kernels import megakernel as mk
        mega_first = (
            updates.get("kernel", param.kernel) in ("auto", "mega")
            and a_op.a.dtype == torch.float32
            and mk.supported(cone) and mk.fits(m, n, cone)
            and _on_card(a_op))
    if row_sharding is not None:
        if param.accel == "" and param.relax == 1.0:
            updates["accel"] = "halpern"
        if param.normalize is None:
            updates["normalize"] = True
    elif dense and n <= 8192 and not mega_first and param.method == "pdhg" \
            and param.matvec_dtype is None and param.relax == 1.0:
        updates["method"] = "direct"
        if param.accel == "":
            updates["accel"] = "halpern"
    elif not dense and param.method == "pdhg" \
            and param.matvec_dtype is None and param.relax == 1.0 \
            and not any(f.kind == PSD for f in cone.factors):
        updates["method"] = "direct"
        if param.accel == "":
            updates["accel"] = "halpern"
    else:
        if param.accel == "" and param.relax == 1.0:
            updates["accel"] = "halpern"
        if param.normalize is None:
            updates["normalize"] = True
        if dense and param.equil_iters is None:
            updates["equil_iters"] = 10
    return dataclasses.replace(param, **updates)


def _as_tensor(x, device) -> torch.Tensor:
    """Tensors keep their device (which must be A's); other data goes to
    A's device."""
    if not isinstance(x, torch.Tensor):
        return torch.from_numpy(np.array(x)).to(device)
    t = x
    if t.device != device:
        raise ValueError(f"c, A and b must share a device: got {t.device} "
                         f"and {device}")
    return t


def solve_jit(
    c,
    a,
    b,
    cone: ConeLayout,
    param: SolverParam = SolverParam(),
    warm_start: Optional[Tuple[Any, Any]] = None,
    resume_state=None,
    row_sharding=None,
    *,
    device=None,
) -> SolveResult:
    """Conic solve that never raises on non-convergence; returns a status.

    Equivalent of Solver::solve + SolverCore::solve (solver.rs:285-457).
    ``c`` (n,), ``a`` (m, n) tensor or :class:`LinOp`, ``b`` (m,);
    ``warm_start`` an optional (x0, y0) primal/dual seed. The solve runs
    on A's device: an A that is not a tensor goes to ``device``, else to
    the CUDA card (a tensor A on another device than ``device`` raises),
    and a ``c`` or ``b`` that is not a tensor follows A. ``profile='fast'``
    is resolved first; ``method='direct'`` then runs the direct engine.
    """
    a_op = as_linop(a, device)
    if param.profile == "fast":
        param = _resolve_fast_profile(param, a_op, cone, row_sharding)
    elif param.profile != "reference":
        raise ValueError(f"unknown profile {param.profile!r}")
    if param.method == "direct":
        if param.matvec_dtype is not None:
            raise ValueError("matvec_dtype is a pdhg-engine feature")
        if row_sharding is not None:
            raise ValueError(
                "method='direct' does not honor row_sharding (mesh "
                "constraints are a pdhg-engine feature); use "
                "method='pdhg', or drop the sharding")
    _check_supported(param, resume_state, row_sharding)
    if not isinstance(a_op, DenseOp):
        raise _not_ported("structured operators", "10")
    device = a_op.a.device
    c = _as_tensor(c, device)
    b = _as_tensor(b, device)
    if param.method == "direct":
        from totsu_tpu_torch.solver.direct import solve_direct_jit
        return solve_direct_jit(c, a_op, b, cone, param,
                                warm_start=warm_start)
    dtype = torch.promote_types(c.dtype, b.dtype)
    c = c.to(dtype)
    b = b.to(dtype)
    # pin A to the iterate dtype
    a_op = DenseOp(a_op.a.to(dtype).contiguous())

    equil_d = equil_e = None
    if param.equil_iters is not None and param.equil_iters > 0:
        from totsu_tpu_torch.solver.scaling import ruiz_equilibrate_op
        a_op, b, c, equil_d, equil_e = ruiz_equilibrate_op(
            a_op, b, c, cone, iters=param.equil_iters)
    # mixed-precision update path: the update loop streams a low-precision
    # copy of A while the criteria keep the exact A; the preconditioner is
    # built from the rounded-then-widened A actually iterated
    mv_op = a_op
    precond_op = a_op
    if param.matvec_dtype is not None:
        mv_op = a_op.astype(param.matvec_dtype)
        precond_op = mv_op.astype(dtype)
    n = c.shape[0]
    m = b.shape[0]
    if cone.dim != m:
        raise ValueError(f"cone dim {cone.dim} != m {m}")
    if a_op.shape != (m, n):
        raise ValueError(f"operator shape {a_op.shape} != ({m}, {n})")

    eps_zero = param.eps_zero
    eps_acc = param.eps_acc
    eps_inf = effective_eps_inf(param, dtype)
    max_iter = param.bounded_max_iter
    check_period = max(1, param.check_period)

    norm_b = torch.linalg.vector_norm(b)
    norm_c = torch.linalg.vector_norm(c)

    # b/c norm normalization: the update iterates on b/||b||, c/||c||;
    # criteria, certificates and solution stay in the un-normalized space
    do_norm = bool(param.normalize) if param.normalize is not None else False
    if do_norm:
        sb = torch.where(norm_b > eps_zero, norm_b, 1.0)
        sc = torch.where(norm_c > eps_zero, norm_c, 1.0)
        b_it = b / sb
        c_it = c / sc
    else:
        sb = sc = None
        b_it, c_it = b, c

    dp_tau, dp_sigma = _precond(precond_op, c_it, b_it, cone, eps_zero)

    # init (SolverCore::init_vecs): u = 0 except tau = 1
    def zeros(k):
        return torch.zeros(k, dtype=dtype, device=device)

    u0 = (zeros(n), zeros(m), zeros(m),
          torch.tensor(1.0, dtype=dtype, device=device))
    v0 = (zeros(n), zeros(m), torch.tensor(0.0, dtype=dtype, device=device))
    if warm_start is not None:
        ws_x, ws_y = warm_start
        ux0, uy0 = u0[0], u0[1]
        if ws_x is not None:
            ws_x = torch.as_tensor(ws_x, dtype=dtype, device=device)
            if equil_e is not None:
                ws_x = ws_x / equil_e
            if do_norm:
                ws_x = ws_x / sb
            ux0 = ws_x
        if ws_y is not None:
            ws_y = torch.as_tensor(ws_y, dtype=dtype, device=device)
            if equil_d is not None:
                ws_y = ws_y / equil_d
            if do_norm:
                ws_y = ws_y / sc
            # keep the seed inside K* (identity for a dual-feasible y)
            uy0 = cone.project(ws_y, dual=True)
        # seed the slack block s = Pi_K(b - A x0) too, so a warm start at
        # the exact solution is a fixed point of the PDHG map
        s_seed = cone.project(b_it - a_op.matvec(ux0), dual=False)
        u0 = (ux0, uy0, s_seed, u0[3])

    relax = float(param.relax)
    if param.accel == "halpern" and relax != 1.0:
        raise ValueError("accel='halpern' requires relax=1.0")

    if _mega_choice(param, a_op, cone, dtype):
        from totsu_tpu_torch.ops.kernels import megakernel
        u, v, k, status, crits = megakernel.solve_mega(
            a_op.a, c_it, b_it, c, b, dp_tau, dp_sigma, u0, v0, cone,
            eps_acc=eps_acc, eps_inf=eps_inf, eps_zero=float(param.eps_zero),
            max_iter=max_iter, check_period=check_period, relax=relax,
            accel=param.accel, sb=sb, sc=sc,
            check_at_start=warm_start is not None)
    else:
        update = _make_update(mv_op, c_it, b_it, dp_tau, dp_sigma, cone,
                              relax)
        check = _make_check(a_op, c, b, norm_b, norm_c, sb, sc, eps_acc,
                            eps_inf, eps_zero, max_iter)
        u, v, k, status, crits = run_loop(
            update, check, u0, v0, cap=max_iter, check_period=check_period,
            accel=param.accel, check_at_start=warm_start is not None,
            dtype=dtype, device=device)
    return _finish(u, k, status, crits, eps_zero, sb, sc, equil_d, equil_e)


def _finish(u, k, status, crits, eps_zero, sb, sc, equil_d,
            equil_e) -> SolveResult:
    """Scale the solution by 1/tau on the tau > eps_zero exit path
    (certificates are returned unscaled), undo normalization and
    equilibration, pack the result."""
    val_tau = u[3]
    pos = val_tau > eps_zero
    scale = torch.where(pos, 1.0 / torch.where(pos, val_tau, 1.0), 1.0)
    sol_x = u[0] * scale
    sol_y = u[1] * scale
    if sb is not None:
        sol_x = sol_x * sb
        sol_y = sol_y * sc
    if equil_e is not None:
        sol_x = sol_x * equil_e
        sol_y = sol_y * equil_d
    return SolveResult(
        x=sol_x, y=sol_y, status=int(status), iters=int(k),
        cri_pri=crits[0], cri_dual=crits[1], cri_gap=crits[2],
        cri_unbdd=crits[3], cri_infeas=crits[4])


def _mega_choice(param: SolverParam, a_op: LinOp, cone: ConeLayout,
                 dtype) -> bool:
    """Resolve SolverParam.kernel: '' keeps the host loop; 'mega' forces
    the whole-solve kernel (its plain version on CPU tensors) and raises
    outside its envelope; 'auto' takes the kernel on a CUDA device inside
    the supported + fitting envelope."""
    if param.kernel not in ("", "auto", "mega"):
        raise ValueError(f"unknown kernel {param.kernel!r}")
    if param.kernel == "":
        return False
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    m, n = a_op.shape
    ok = (type(a_op) is DenseOp and dtype == torch.float32
          and param.matvec_dtype is None
          and param.accel in ("", "halpern") and mk.supported(cone)
          and mk.fits(m, n, cone))
    if param.kernel == "mega":
        if not ok:
            raise ValueError(
                "kernel='mega' requires a dense f32 A inside the kernel's "
                f"envelope ({mk.A_BUDGET_BYTES >> 20} MiB), zero/R+/SOC/"
                "RSOC/exp/pow cones, accel in ('', 'halpern'), no "
                "matvec_dtype")
        return True
    return ok and a_op.a.device.type == "cuda"


def solve_sequence(problems, param: SolverParam = SolverParam(),
                   warm_start=None, *, device=None):
    """Solve a sequence of same-shaped problems, warm-starting each from
    the previous solution. ``problems`` yields (c, a, b, cone) tuples or
    ConicProblems; returns the list of SolveResults. ``device`` as in
    :func:`solve_jit`."""
    results = []
    ws = warm_start
    for prob in problems:
        if hasattr(prob, "cone"):
            c, a, b, cone = prob.c, prob.a, prob.b, prob.cone
        else:
            c, a, b, cone = prob
        res = solve(c, a, b, cone, param, warm_start=ws, device=device)
        results.append(res)
        ws = (res.x, res.y)
    return results


def solve(
    c,
    a,
    b,
    cone: ConeLayout,
    param: SolverParam = SolverParam(),
    warm_start: Optional[Tuple[Any, Any]] = None,
    row_sharding=None,
    polish: bool = False,
    chunk_iters: Optional[int] = None,
    *,
    device=None,
) -> SolveResult:
    """Host-facing solve: raises :class:`SolverError` on non-convergence
    like the reference's ``Result`` (solver.rs:285-322). Use
    :func:`solve_jit` for the never-raising version; ``device`` as
    there."""
    if polish:
        raise _not_ported("polish=True", "13")
    if chunk_iters is not None:
        raise _not_ported("chunk_iters", "9")
    result = solve_jit(c, a, b, cone, param, warm_start=warm_start,
                       row_sharding=row_sharding, device=device)
    if result.status != SolverStatus.CONVERGED:
        raise SolverError(result.status)
    return result
