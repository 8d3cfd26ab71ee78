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
the loop's only host sync (a logged check, ``log_period > 0``, reads its
printed numbers too). ``kernel='mega'`` runs the whole loop instead
in one CUDA kernel launch (``ops/kernels/megakernel.py``).
``method='direct'`` hands the solve to the direct engine
(``solver/direct.py``: a cached solve for a dense A, CG for any other
operator); ``profile='fast'`` picks engine and knobs first
(:func:`_resolve_fast_profile`), and :func:`solve` switches on Ruiz for
badly scaled structured data (:func:`_maybe_auto_equil`).
``return_state`` hands back a :class:`ResumeState` that
``resume_state`` continues exactly, and ``solve(chunk_iters=N)`` runs a
solve as such a chain of N-iteration calls.
"""

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from totsu_tpu_torch.solver.cone import (ConeLayout, RSOC, EXP, POW, PSD,
                                         resolve_auto_methods)
from totsu_tpu_torch.solver.operator import (LinOp, BatchedDenseOp, DenseOp,
                                            as_linop, full_f32_matmul,
                                            pin_dtype)
from totsu_tpu_torch.solver.params import (SolverParam, SolverStatus,
                                           SolverError, effective_eps_inf)
from totsu_tpu_torch.utils.trace import span

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


@dataclasses.dataclass(frozen=True)
class ResumeState:
    """Checkpoint of a running solve (``SolveResult.state``), enough to
    resume it exactly:

    * ``u`` / ``v`` — the iterate pair (segment tuples on the pdhg
      engine, flat ``(n + m + 1,)`` tensors on the direct engine);
    * ``k`` — the global iteration count (a Python int), so the restart
      rules see the uninterrupted clock; a resumed solve still reports
      the iterations of its own call;
    * ``aux`` — a dict of tensors and ints: the accel epoch (Halpern
      anchor and counters, restart running sums), the direct engine's
      cached solve of I + A^T A and Sherman-Morrison border, and the last
      criteria and status. An empty dict (a megakernel checkpoint, whose
      in-kernel epoch is not exported) resumes with a fresh accel epoch;
    * ``engine`` / ``accel`` — resuming another engine raises (the
      iteration variables differ); another accel starts a fresh epoch.

    The caches are keyed to the problem data: resume only the (c, A, b)
    that produced the checkpoint. A changed problem takes ``warm_start``.
    """
    u: Any
    v: Any
    k: int
    aux: Any
    engine: str = "pdhg"
    accel: str = ""


def _tensors(x):
    """Every tensor inside nested tuples / dicts."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _tensors(item)]
    return []


def _unpack_resume(resume_state, engine: str, accel: str, device, dtype):
    """(u0, v0, k0, aux) from a ResumeState or a legacy bare (u, v) tuple.

    ``aux`` is None when the checkpoint carries no epoch state for this
    engine and accel (legacy tuples, megakernel checkpoints, another
    accel): the solve then resumes with a fresh accel epoch. Another
    engine raises, and so does a checkpoint whose tensors are not on A's
    device in the iterate dtype (it is never moved silently)."""
    other = "direct" if engine == "pdhg" else "pdhg"
    if isinstance(resume_state, ResumeState):
        if resume_state.engine != engine:
            raise ValueError(
                f"resume_state was produced by the {resume_state.engine} "
                f"engine and cannot resume method='{engine}' (different "
                "iteration variables); resume with the same method/profile "
                "that produced it")
        u0, v0, k0 = resume_state.u, resume_state.v, int(resume_state.k)
        aux = resume_state.aux if resume_state.accel == accel else None
        if aux is not None and len(aux) == 0:
            aux = None
    else:
        u0, v0 = resume_state
        seg = isinstance(u0, tuple) and len(u0) == 4
        if seg != (engine == "pdhg"):
            raise ValueError(
                f"resume_state was produced by the {other} engine and "
                f"cannot resume method='{engine}' (different iteration "
                "variables); resume with the same method/profile that "
                "produced it")
        k0, aux = 0, None
    for t in _tensors((u0, v0, aux)):
        if t.device != device or t.dtype != dtype:
            raise ValueError(
                f"resume_state holds a {t.dtype} tensor on {t.device}; the "
                f"solve runs in {dtype} on {device}")
    return u0, v0, k0, aux


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


def _log_due(k: int, check_period: int, log_period: int) -> bool:
    """Whether the check at ``k`` prints its progress line."""
    return log_period > 0 and \
        (k - check_period) % log_period < check_period


def _run_plain(update, check, u, v, k: int, status: int, crits, cap: int,
               check_period: int, aux=None, log_period: int = 0):
    """The reference iteration: ``check_period`` updates, one check, one
    host read of the status, until a terminal status or the cap. Carries
    no epoch state: ``aux`` is ignored and the returned one is empty."""
    while status == SolverStatus.RUNNING and k < cap:
        for _ in range(check_period):
            u, v = update(u, v)
        k += check_period
        st, crits = check(u, v, k)
        status = int(st.item())
        if _log_due(k, check_period, log_period):
            p, d, g, ub, inf = crits.tolist()
            print(f"{k}: pri_dual_gap {p:.2e} {d:.2e} {g:.2e} "
                  f"unbdd_infeas {ub:.2e} {inf:.2e}")
    return u, v, k, status, crits, {}


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
    periods): the int ``ke`` compared in the iterate dtype ``ndt``, ``k``
    the global iteration count (a resumed loop's too)."""
    return bool(ndt.type(ke) >= max(ndt.type(0.36) * ndt.type(k),
                                    ndt.type(4.0 * check_period)))


def _run_halpern(update, check, u0, v0, k: int, status: int, crits,
                 cap: int, check_period: int, aux=None, log_period: int = 0):
    """Restarted reflected-Halpern PDHG (rHPDHG; Lu & Yang 2024):

        z_{k+1} = (k+1)/(k+2) * (2 T(z_k) - z_k) + 1/(k+2) * z_0,

    restarting the epoch from the projected point T(z) when the
    fixed-point residual ||T(z) - z|| decays sufficiently (x0.2), stalls
    after a necessary decay (x0.8), or the epoch exceeds 36% of all
    iterations; termination is evaluated at T(z). The restart decision is
    computed on the device in the iterate dtype and read to the host with
    the status in one transfer per check.

    ``aux`` (a checkpoint's epoch) restores the anchor and the counters.
    The result takes T(z) on exit; the returned ``aux`` keeps apart the
    raw carry ``ru, rv`` the loop would have continued from, which is
    where an exact resume starts."""
    dtype = u0[0].dtype
    ndt = _np_dtype(dtype)
    u, v, ru, rv = u0, v0, u0, v0
    if aux is not None:
        au, av, ke = aux["au"], aux["av"], aux["ke"]
        fp_rst, fp_last = aux["fp_rst"], aux["fp_last"]
    else:
        au, av, ke = u0, v0, 0
        fp_rst = fp_last = torch.tensor(float("inf"), dtype=dtype,
                                        device=u0[0].device)
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
        ru, rv = (tu, tv) if restart else (u, v)
        if restart or status != SolverStatus.RUNNING:
            u, v = tu, tv
        if restart:
            au, av = tu, tv
            ke = 0
            fp_rst = fp
        fp_last = fp
        if _log_due(k, check_period, log_period):
            print(f"{k}: fp_res {float(fp):.2e} (restart={bool(restart)})")
    return u, v, k, status, crits, {
        "au": au, "av": av, "ke": ke, "fp_rst": fp_rst, "fp_last": fp_last,
        "ru": ru, "rv": rv}


def _run_restarted(update, check, u0, v0, k: int, status: int, crits,
                   cap: int, check_period: int, aux=None,
                   log_period: int = 0):
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
    restart decision reach the host in one transfer per check.

    ``aux`` (a checkpoint's epoch) restores the running sums and the
    counters; the returned one holds the raw carry ``ru, rv`` apart from
    the point the result takes on exit, as in :func:`_run_halpern`."""
    dtype = u0[0].dtype
    ndt = _np_dtype(dtype)
    u, v, ru, rv = u0, v0, u0, v0

    def zeros(seg):
        return tuple(torch.zeros_like(x) for x in seg)

    if aux is not None:
        su, sv, ke = aux["su"], aux["sv"], aux["ke"]
        res_rst, res_last = aux["res_rst"], aux["res_last"]
    else:
        su, sv, ke = zeros(u0), zeros(v0), 0
        res_rst = res_last = torch.tensor(float("inf"), dtype=dtype,
                                          device=u0[0].device)
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
        ru, rv = (ub, vb) if restart and use_avg else (u, v)
        if (restart or status != SolverStatus.RUNNING) and use_avg:
            u, v = ub, vb
        if restart:
            su, sv = zeros(u0), zeros(v0)
            ke = 0
            res_rst = res
        res_last = res
        if _log_due(k, check_period, log_period):
            print(f"{k}: res {float(res):.2e} (restart={bool(restart)})")
    return u, v, k, status, crits, {
        "su": su, "sv": sv, "ke": ke, "res_rst": res_rst,
        "res_last": res_last, "ru": ru, "rv": rv}


def _is_terminal(status: int) -> bool:
    return status not in (SolverStatus.RUNNING, SolverStatus.EXCESS_ITER)


def initial_status(check, u0, v0, k: int, aux, check_at_start: bool,
                   dtype, device):
    """(status, crits) a loop starts from. A checkpoint's saved criteria
    are restored, not re-checked (the raw carry of an accel loop may lie
    outside the cones, where the certificates mean nothing): EXCESS_ITER
    becomes RUNNING, a terminal status stays terminal. Otherwise a seeded
    start (warm start or resume) is checked, so an already-converged seed
    stops at 0 iterations; a cold start is RUNNING."""
    if aux is not None and "crits" in aux:
        status = aux.get("status", SolverStatus.RUNNING)
        if status == SolverStatus.EXCESS_ITER:
            status = SolverStatus.RUNNING
        return int(status), aux["crits"]
    if check_at_start:
        st, crits = check(u0, v0, k)
        return int(st.item()), crits
    return (int(SolverStatus.RUNNING),
            torch.full((5,), float("inf"), dtype=dtype, device=device))


_LOOPS = {"": _run_plain, "halpern": _run_halpern,
          "restart": _run_restarted}

# the epoch state each accel loop needs to resume exactly
_EPOCH_KEYS = {
    "": set(),
    "halpern": {"au", "av", "ke", "fp_rst", "fp_last", "ru", "rv"},
    "restart": {"su", "sv", "ke", "res_rst", "res_last", "ru", "rv"},
}


def run_loop(update, check, u0, v0, *, cap: int, check_period: int,
             accel: str, check_at_start: bool, dtype, device, k_start=0,
             aux=None, log_period: int = 0):
    """The pdhg loop shared by :func:`solve_jit` and the megakernel's plain
    version: ``(u, v, k, status, crits, aux)`` after iterating from
    (u0, v0) at the global count ``k_start`` up to ``cap``; ``aux`` a
    checkpoint's epoch state, or None."""
    run = _LOOPS.get(accel)
    if run is None:
        raise ValueError(f"unknown accel {accel!r}")
    status, crits = initial_status(check, u0, v0, k_start, aux,
                                   check_at_start, dtype, device)
    return run(update, check, u0, v0, k_start, status, crits, cap,
               check_period, aux=aux, log_period=log_period)


def _check_supported(param: SolverParam, row_sharding, a_op: LinOp):
    """Raise for an unknown method or accel, and for a ``row_sharding``
    that is not the port's record (``TypeError``) or that A does not
    carry (``ValueError``: A must be the sharded operator of
    ``parallel.shard_dense_problem`` or ``shard_blocked_ell_problem``
    over the same split). Runs after the fast profile is resolved."""
    if param.method not in ("pdhg", "direct"):
        raise ValueError(f"unknown method {param.method!r}")
    if param.accel not in ("", "halpern", "restart"):
        raise ValueError(f"unknown accel {param.accel!r}")
    if row_sharding is not None:
        from totsu_tpu_torch.parallel.sharded import RowSharding
        if not isinstance(row_sharding, RowSharding):
            raise TypeError(f"row_sharding must be a parallel.RowSharding "
                            f"(from shard_dense_problem), got "
                            f"{type(row_sharding).__name__}")
        if getattr(a_op, "sharding", None) != row_sharding:
            raise ValueError("row_sharding: A is not sharded over this split "
                             "(pass the problem that shard_dense_problem or "
                             "shard_blocked_ell_problem returned)")


def _on_card(a_op: LinOp) -> bool:
    """Whether the solve runs on a CUDA device: the fast profile asks this
    where the JAX package asks whether it runs on a TPU. Any operator
    answers by its ``device``; one without a device is not on the card."""
    device = getattr(a_op, "device", None)
    return device is not None and device.type == "cuda"


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
      mode), PSD layouts excepted;
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
            and a_op.dtype == torch.float32
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
    Every product runs in full f32 (:func:`full_f32_matmul`). While a torch
    profiler records, the call is its range ``totsu.solve``.
    """
    with span("totsu.solve"), full_f32_matmul():
        return _solve_jit(c, a, b, cone, param, warm_start, resume_state,
                          row_sharding, device)


def _solve_jit(c, a, b, cone, param, warm_start, resume_state, row_sharding,
               device) -> SolveResult:
    # psd(method='auto') factors first, with the original param (the
    # fast profile rewrites ``profile``)
    cone = resolve_auto_methods(cone, param)
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
    _check_supported(param, row_sharding, a_op)
    device = a_op.device
    c = _as_tensor(c, device)
    b = _as_tensor(b, device)
    if param.method == "direct":
        from totsu_tpu_torch.solver.direct import solve_direct_jit
        return solve_direct_jit(c, a_op, b, cone, param,
                                warm_start=warm_start,
                                resume_state=resume_state)
    dtype = torch.promote_types(c.dtype, b.dtype)
    c = c.to(dtype)
    b = b.to(dtype)
    # pin A to the iterate dtype (any operator: the JAX package pins only
    # a dense A)
    a_op = pin_dtype(a_op, dtype)

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
    k_start = 0
    resume_aux = None
    if resume_state is not None:
        u0, v0, k_start, resume_aux = _unpack_resume(
            resume_state, "pdhg", param.accel, device, dtype)
        taken = (u0, v0)
        if resume_aux is not None \
                and not _EPOCH_KEYS[param.accel] <= set(resume_aux):
            # no epoch state for this loop (e.g. a megakernel checkpoint):
            # a fresh epoch
            resume_aux = None
        if resume_aux is not None and "ru" in resume_aux \
                and not _is_terminal(resume_aux.get("status",
                                                    SolverStatus.RUNNING)):
            # the raw carry the uninterrupted loop would continue from; a
            # terminal checkpoint keeps its taken pair, the point its
            # saved criteria describe
            u0, v0 = resume_aux["ru"], resume_aux["rv"]
    elif warm_start is not None:
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

    seeded = warm_start is not None or resume_state is not None
    if _mega_choice(param, a_op, cone, dtype):
        from totsu_tpu_torch.ops.kernels import megakernel
        # an accel checkpoint of the host loop seeds the kernel from its
        # taken pair, not the raw carry: the kernel starts a fresh epoch
        # anyway, and its check at the seed needs a point inside the cones
        seed_u, seed_v = taken if resume_state is not None else (u0, v0)
        u, v, k, status, crits = megakernel.solve_mega(
            a_op.a, c_it, b_it, c, b, dp_tau, dp_sigma, seed_u, seed_v,
            cone, eps_acc=eps_acc, eps_inf=eps_inf,
            eps_zero=float(param.eps_zero), max_iter=max_iter,
            check_period=check_period, relax=relax, accel=param.accel,
            sb=sb, sc=sc, check_at_start=seeded)
        # the kernel counts per call and exports no epoch: the checkpoint
        # carries an empty aux, and a resume starts a fresh epoch
        k, aux = k_start + k, None
    else:
        # the global cap: a resumed loop continues from k_start, and
        # max_iter bounds the iterations of this call
        cap = k_start + max_iter
        update = _make_update(mv_op, c_it, b_it, dp_tau, dp_sigma, cone,
                              relax)
        check = _make_check(a_op, c, b, norm_b, norm_c, sb, sc, eps_acc,
                            eps_inf, eps_zero, cap)
        u, v, k, status, crits, aux = run_loop(
            update, check, u0, v0, cap=cap, check_period=check_period,
            accel=param.accel, check_at_start=seeded, dtype=dtype,
            device=device, k_start=k_start, aux=resume_aux,
            log_period=param.log_period)
    return _finish(u, k - k_start, status, crits, eps_zero, sb, sc, equil_d,
                   equil_e, state=_checkpoint(param, "pdhg", u, v, k, aux,
                                              status, crits))


def _checkpoint(param: SolverParam, engine: str, u, v, k: int, aux, status,
                crits) -> Optional[ResumeState]:
    """The ResumeState of ``param.return_state`` (else None). ``aux`` None
    means no exportable epoch (the megakernel): an empty dict. Otherwise
    the last criteria and status ride along, so a resume restores them
    instead of checking a possibly reflected seed."""
    if not param.return_state:
        return None
    aux = {} if aux is None else {**aux, "crits": crits, "status": status}
    return ResumeState(u=u, v=v, k=k, aux=aux, engine=engine,
                       accel=param.accel)


def _finish(u, iters, status, crits, eps_zero, sb, sc, equil_d,
            equil_e, state=None, diag=None) -> SolveResult:
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
        x=sol_x, y=sol_y, status=int(status), iters=int(iters),
        cri_pri=crits[0], cri_dual=crits[1], cri_gap=crits[2],
        cri_unbdd=crits[3], cri_infeas=crits[4], state=state, diag=diag)


def _mega_choice(param: SolverParam, a_op: LinOp, cone: ConeLayout,
                 dtype) -> bool:
    """Resolve SolverParam.kernel: '' keeps the host loop; 'mega' forces
    the whole-solve kernel (its plain version on CPU tensors) and raises
    outside its envelope, and prints no progress lines; 'auto' takes the
    kernel on a CUDA device inside the supported + fitting envelope,
    except with progress logging, where it warns and keeps the host
    loop. A batch (``solver/batched.py``) resolves the same way on its
    :class:`BatchedDenseOp`, each lane's A within the envelope."""
    if param.kernel not in ("", "auto", "mega"):
        raise ValueError(f"unknown kernel {param.kernel!r}")
    if param.kernel == "":
        return False
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    m, n = a_op.shape
    ok = (type(a_op) in (DenseOp, BatchedDenseOp)
          and dtype == torch.float32
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
    if ok and _on_card(a_op) and param.log_period != 0:
        # loud, not silent: the kernel cannot print, and losing it costs
        # the host loop's launch overhead; _resolve_fast_profile knows
        # this rule and routes logged fast-profile solves elsewhere
        import warnings
        warnings.warn(
            "kernel='auto': progress logging (log_period > 0) disables the "
            "CUDA megakernel (it cannot print); set log_period=0 to "
            "re-enable it, or kernel='' to silence this warning.",
            RuntimeWarning, stacklevel=3)
        return False
    return ok and _on_card(a_op)


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
    there.

    ``chunk_iters=N`` runs the solve as a chain of N-iteration
    :func:`solve_jit` calls stitched with exact ``resume_state``
    checkpoints (``param.max_iter`` caps the total exactly; the tail
    chunk is shortened to fit). The host loops and the direct engine
    resume exactly, the accel epochs and the direct engine's cached
    solve included, so the chunked solve takes the same iterations to the
    same x; megakernel chunks start a fresh accel epoch (the kernel
    exports none).

    On a structured operator under ``profile='fast'`` with ``equil_iters``
    unset, a probe of the data's column spread may switch on Ruiz first
    (:func:`_maybe_auto_equil`); an indirect-engine solve whose CG hit its
    cap warns (:func:`_warn_cg_truncation`).

    ``polish=True`` refines the converged solution on the host in f64
    (``solver/polish.py``: zero/rpos/SOC/RSOC/PSD cones, so the qp() and
    qcqp() epigraph reductions polish too; exp/pow/custom layouts warn and
    return unpolished; a structured operator is densified under a size
    guard and an oversize one raises) and returns the refined x and y with
    every criterion recomputed at the polished point
    (:func:`_apply_polish`), on the chunked path too."""
    a_op = as_linop(a, device)
    param = _maybe_auto_equil(param, a_op, row_sharding)
    if chunk_iters is not None:
        result = _solve_chunked(c, a_op, b, cone, param, warm_start,
                                row_sharding, int(chunk_iters))
    else:
        result = solve_jit(c, a_op, b, cone, param, warm_start=warm_start,
                           row_sharding=row_sharding)
    _warn_cg_truncation(result)
    if result.status != SolverStatus.CONVERGED:
        raise SolverError(result.status)
    if polish:
        result = _apply_polish(result, c, a_op, b, cone, param)
    return result


def _apply_polish(result: SolveResult, c, a_op: LinOp, b,
                  cone: ConeLayout, param: SolverParam) -> SolveResult:
    """Host-side f64 active-set refinement of a converged result, with
    every criterion, the certificate fields included, recomputed at the
    polished point (the in-loop check's formulas at the tau = 1 solution,
    where s = b - A x, so p_inf = b exactly).

    Two choices differ from a literal copy of the JAX package, which
    computes A^T y with ``as_linop(a).rmatvec`` on the device and hands
    back arrays in its x64 dtype:

    * A^T y is computed on the host from the f64 dense A that the polish
      built (:func:`polish.host_matrix`): an f32 A against the f64
      polished y would raise in torch, where jnp widens;
    * x, y and the criteria come back as f64 tensors on A's device,
      whatever the solve's dtype: rounding them to f32 would undo the
      polish (its residuals reach about 1e-9 and below)."""
    from totsu_tpu_torch.solver import polish as polish_mod
    a_np = polish_mod.host_matrix(a_op)
    pr = polish_mod.polish(result, c, a_np, b, cone)
    if not pr.polished:
        return result
    cn, bn = polish_mod._host(c), polish_mod._host(b)
    gx, gy = float(cn @ pr.x), float(bn @ pr.y)
    aty = a_np.T @ pr.y
    nb_, nc_ = np.linalg.norm(bn), np.linalg.norm(cn)
    m_cx, m_by = -gx, -gy
    cri_unbdd = (float(nb_ * nc_ / m_cx)
                 if m_cx > param.eps_zero else np.inf)
    cri_infeas = (float(np.linalg.norm(aty) * nb_ / m_by)
                  if m_by > param.eps_zero else np.inf)

    def dev(v):
        return torch.tensor(v, dtype=torch.float64, device=a_op.device)

    return dataclasses.replace(
        result, x=dev(pr.x), y=dev(pr.y),
        cri_pri=dev(pr.pri_res / (1.0 + nb_)),
        cri_dual=dev(pr.dual_res / (1.0 + nc_)),
        cri_gap=dev(abs(gx + gy) / (1.0 + abs(gx) + abs(gy))),
        cri_unbdd=dev(cri_unbdd), cri_infeas=dev(cri_infeas))


#: Auto-equilibration threshold on ``scaling_spread`` (the column 2-norm
#: spread). The JAX package calibrated it on a TPU: well-scaled instance
#: classes probe at 1.1-2.9, where Ruiz measurably hurt, the ill-scaled
#: family at 24-172, where equilibration was the only converging
#: configuration. Unmeasured on the H100 (ROADMAP item 17).
_AUTO_EQUIL_SPREAD = 10.0


def _maybe_auto_equil(param: SolverParam, a_op, row_sharding):
    """The host-side, data-driven leg of the fast profile: switch on Ruiz
    equilibration (``equil_iters=10``) for a badly scaled structured
    operator. It fires only when every condition holds: ``profile='fast'``,
    ``equil_iters`` unset (None; an explicit value, 0 included, wins),
    no ``row_sharding``, an operator that is not dense and has the
    absmax/diag_scale trio Ruiz needs and the ``col_sqsum`` the probe
    reads, and a column spread past :data:`_AUTO_EQUIL_SPREAD`. A stack
    whose child lacks the trio (e.g. ``VStackOp((CustomOp, DiagOp))``)
    raises inside the probe: the policy stands down. The spread is kept
    on the operator instance, so a sequence reusing one operator probes
    once (one device reduction and one host read)."""
    if (param.profile != "fast" or param.equil_iters is not None
            or row_sharding is not None):
        return param
    if isinstance(a_op, DenseOp) or not isinstance(a_op, LinOp):
        return param
    t = type(a_op)
    if (t.diag_scale is LinOp.diag_scale
            or t.row_absmax is LinOp.row_absmax
            or t.col_absmax is LinOp.col_absmax
            or t.col_sqsum is LinOp.col_sqsum):
        return param
    spread = getattr(a_op, "_spread_memo", None)
    if spread is None:
        from totsu_tpu_torch.solver.scaling import scaling_spread
        try:
            spread = scaling_spread(a_op)
        except NotImplementedError:
            # a child of a composite stack lacks the trio: Ruiz could not
            # run either. NaN compares False below
            spread = float("nan")
        object.__setattr__(a_op, "_spread_memo", spread)
    if spread > _AUTO_EQUIL_SPREAD:
        return dataclasses.replace(param, equil_iters=10)
    return param


def _warn_cg_truncation(result):
    """Warn when the indirect engine's CG cap cut resolvent solves far
    short of their tolerance (worst relative residual past 10x the
    target): the DR iteration then ran on inexact resolvents."""
    d = result.diag
    if d is None or "cg_worst_rel" not in d:
        return
    worst = float(d["cg_worst_rel"])
    tol = float(d["cg_tol"])
    if worst > 10.0 * tol:
        import warnings
        warnings.warn(
            "indirect engine: CG resolvent solves hit the iteration cap "
            f"(worst relative residual {worst:.1e} vs target {tol:.1e}) "
            "— the solve ran on inexact resolvents. For badly scaled "
            "data set equil_iters=10 (Ruiz; profile='fast' switches it "
            "on automatically when the data's column-norm spread "
            "exceeds 10); cg_precond='jacobi' is already the default for "
            "operators that support col_sqsum.",
            RuntimeWarning, stacklevel=3)


def _solve_chunked(c, a_op, b, cone, param, warm_start, row_sharding,
                   chunk_iters: int) -> SolveResult:
    """solve(..., chunk_iters=N): the first chunk takes ``warm_start``,
    each later one the previous chunk's checkpoint; a chunk that ends
    RUNNING or EXCESS_ITER at the cap reports EXCESS_ITER. The result's
    ``iters`` is the total, and it keeps ``state`` only if ``param``
    asks for it."""
    if chunk_iters <= 0:
        raise ValueError(f"chunk_iters must be positive, got {chunk_iters}")
    cap = param.bounded_max_iter
    p_chunk = dataclasses.replace(param, max_iter=min(chunk_iters, cap),
                                  return_state=True)
    res = solve_jit(c, a_op, b, cone, p_chunk, warm_start=warm_start,
                    row_sharding=row_sharding)
    total = res.iters
    while res.status == SolverStatus.EXCESS_ITER and total < cap:
        p_i = dataclasses.replace(p_chunk,
                                  max_iter=min(chunk_iters, cap - total))
        res = solve_jit(c, a_op, b, cone, p_i, resume_state=res.state,
                        row_sharding=row_sharding)
        total += res.iters
    status = res.status
    if status == SolverStatus.RUNNING:
        status = int(SolverStatus.EXCESS_ITER)
    return dataclasses.replace(
        res, status=status, iters=total,
        state=res.state if param.return_state else None)
