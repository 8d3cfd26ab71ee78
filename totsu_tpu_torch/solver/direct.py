"""Direct (SCS-style) solve of the homogeneous self-dual embedding.

Port of ``totsu_tpu.solver.direct``: Douglas-Rachford splitting
(O'Donoghue et al., SCS) of the same embedding the pdhg engine iterates,

    u~  <- (I + Q)^{-1} (u + v)            (linear solve)
    u   <- Pi_C(u~ - v)                    (cone projection)
    v   <- v - u~ + u

with Q = [[0, A^T, c], [-A, 0, b], [-c^T, -b^T, 0]] and
C = R^n x K* x R+ over u = (x, y, tau), one flat (n + m + 1) vector.
Block elimination and a Sherman-Morrison correction on the (c, b) border
reduce the (I + Q) solve to the SPD matrix M = I + A^T A:

    M z1 = r1 - A^T r2,   z2 = r2 + A z1,
    (I + Q) solve = M-solve + rank-1 correction with g = M^{-1} (c, b).

On a dense A, M is factored once (:func:`spd_cache`): Cholesky in f64
(cuSOLVER on the card); in f32 a Newton-Schulz inverse, after which every
solve takes two refinement steps, as in the JAX package. On any other
operator (the indirect mode, SCS's "indirect" linear-system mode) each
M-solve runs warm-started, optionally Jacobi-preconditioned conjugate
gradient (:func:`_cg`) from the previous resolvent's solution, threaded
through the DR loop (and a checkpoint) as ``ws``. Every matrix product
runs in full f32 (:func:`full_f32_matmul`): a TF32 resolvent breaks the
firm nonexpansiveness of the DR map.

The JAX ``lax.while_loop`` becomes a host loop, as in the pdhg engine:
``check_period`` updates, one check (whose ``dual_matvec`` is kernel 1 on
a dense A on the card; exp/pow blocks of ``Pi_C`` run kernel B), one host
read of the status. A checkpoint (``return_state``) carries the cached
solve, the Sherman-Morrison border and the CG warm start, so a resumed
solve skips the O(n^3) build and the border's solve.
"""

import dataclasses
from typing import Optional

import torch

from totsu_tpu_torch.solver.cone import ConeLayout
from totsu_tpu_torch.solver.conic import (
    SolveResult, _artificial_restart, _checkpoint, _finish, _halpern_weights,
    _is_terminal, _make_check, _np_dtype, _run_plain, _unpack_resume,
    initial_status)
from totsu_tpu_torch.solver.operator import (DenseOp, full_f32_matmul,
                                            pin_dtype)
from totsu_tpu_torch.solver.params import (SolverParam, SolverStatus,
                                           effective_eps_inf)


def _matmul(x, y):
    """Every matrix product of the engine: A^T A, the Newton-Schulz
    steps and the products of each solve."""
    return torch.matmul(x, y)


@dataclasses.dataclass(frozen=True)
class SpdSolve:
    """The cached solve of M = I + A^T A: its lower Cholesky factor
    (f64), or its Newton-Schulz inverse and the steps that built it
    (f32), after which every solve takes two refinement steps."""
    factor: torch.Tensor
    cholesky: bool
    ns_steps: int

    @property
    def refine_steps(self) -> int:
        return 0 if self.cholesky else 2

    def aux(self) -> dict:
        """The checkpoint's entries for this cache."""
        key = "chol_c" if self.cholesky else "prec"
        return {key: self.factor, "ns_steps": self.ns_steps,
                "refine_steps": self.refine_steps}

    @classmethod
    def from_aux(cls, aux: dict, dtype) -> Optional["SpdSolve"]:
        """The cache a checkpoint carries for an iterate ``dtype`` (the
        lower Cholesky factor in f64, the inverse otherwise), or None."""
        cholesky = dtype == torch.float64
        factor = aux.get("chol_c" if cholesky else "prec")
        if factor is None:
            return None
        out = cls(factor, cholesky, int(aux.get("ns_steps", 0)))
        if int(aux.get("refine_steps", out.refine_steps)) \
                != out.refine_steps:
            raise ValueError("resume_state's cache takes "
                             f"{aux['refine_steps']} refinement steps, this "
                             f"solve {out.refine_steps}")
        return out

    def apply_inv(self, r):
        if self.cholesky:
            return torch.cholesky_solve(r[:, None], self.factor)[:, 0]
        return _matmul(self.factor, r)


def newton_schulz_inverse(spd):
    """(X, steps): X_{k+1} = X_k (2I - M X_k) from X_0 = I / ||M||_F
    (which is at least lambda_max), while the residual ||I - X M||_F
    falls, stays above 1e-7 and steps < 100; the last step taken is
    kept (the JAX package's loop). Each step's stopping test is one host
    read."""
    n = spd.shape[0]
    eye = torch.eye(n, dtype=spd.dtype, device=spd.device)
    x = eye / torch.linalg.matrix_norm(spd)
    res = torch.linalg.matrix_norm(eye - _matmul(x, spd))
    res_prev = torch.full_like(res, float("inf"))
    steps = 0
    while steps < 100 and bool((res < res_prev) & (res > 1e-7)):
        x = _matmul(x, 2.0 * eye - _matmul(spd, x))
        res, res_prev = torch.linalg.matrix_norm(eye - _matmul(x, spd)), res
        steps += 1
    return x, steps


def spd_cache(amat) -> SpdSolve:
    """Factor M = I + A^T A for an (m, n) A: Cholesky in f64, else the
    Newton-Schulz inverse with two refinement steps per solve."""
    n = amat.shape[1]
    spd = torch.eye(n, dtype=amat.dtype, device=amat.device) \
        + _matmul(amat.T, amat)
    if amat.dtype == torch.float64:
        return SpdSolve(torch.linalg.cholesky(spd), True, 0)
    prec, steps = newton_schulz_inverse(spd)
    return SpdSolve(prec, False, steps)


def _run_halpern_dr(t_map, pair, check, z0, k: int, status: int, crits,
                    cap: int, check_period: int, aux=None):
    """Restarted Halpern iteration on the DR variable z = u~ - v,

        z_{k+1} = (k+1)/(k+2) * (2 T(z_k) - z_k) + 1/(k+2) * z_anchor,

    with T firmly nonexpansive in z. The epoch restarts (anchor <- T(z))
    on sufficient decay (x0.2) or stalled necessary decay (x0.8) of the
    fixed-point residual ||T(z) - z||, or past 36% of all iterations.
    Termination is evaluated at the Moreau pair of T(z), projected and
    feasible, so the statuses keep their certificate meaning. The restart
    decision reaches the host with the status in one transfer per
    check. ``aux`` (a checkpoint's epoch) restores the anchor and the
    counters. Returns (z, k, status, crits, aux), the returned ``aux``
    holding the raw carry ``z`` the loop would continue from (z itself
    takes T(z) on exit)."""
    dtype = z0.dtype
    ndt = _np_dtype(dtype)
    z = rz = z0
    if aux is not None:
        anchor, ke = aux["anchor"], aux["ke"]
        fp_rst, fp_last = aux["fp_rst"], aux["fp_last"]
    else:
        anchor, ke = z0, 0
        fp_rst = fp_last = torch.tensor(float("inf"), dtype=dtype,
                                        device=z0.device)
    while status == SolverStatus.RUNNING and k < cap:
        for _ in range(check_period):
            tz = t_map(z)
            w, wa = _halpern_weights(ndt, ke)
            z = w * (2.0 * tz - z) + wa * anchor
            ke += 1
        k += check_period
        tz = t_map(z)
        fp = torch.linalg.vector_norm(tz - z)
        st, crits = check(*pair(tz), k)
        restart = (fp <= 0.2 * fp_rst) \
            | ((fp <= 0.8 * fp_rst) & (fp > fp_last)) \
            | _artificial_restart(ndt, ke, k, check_period)
        status, restart = (int(x) for x in
                           torch.stack([st, restart.to(torch.int32)]).tolist())
        rz = tz if restart else z
        if restart or status != SolverStatus.RUNNING:
            z = tz
        if restart:
            anchor = tz
            ke = 0
            fp_rst = fp
        fp_last = fp
    return z, k, status, crits, {"anchor": anchor, "ke": ke,
                                 "fp_rst": fp_rst, "fp_last": fp_last,
                                 "z": rz}


def _cg(apply_fn, rhs, x0, rel_tol: float, max_cg: int, inv_diag=None):
    """Warm-started (optionally Jacobi-preconditioned) conjugate gradient
    on an SPD operator: the step-for-step port of the JAX package's
    ``lax.while_loop``. ``apply_fn(z) = z + A^T (A z)`` has eigenvalues in
    [1, 1 + sigma_max(A)^2], so plain CG converges geometrically;
    ``inv_diag`` (the reciprocal of diag(I + A^T A)) makes it Jacobi PCG,
    the lever for badly column-scaled data. The stopping test reads the
    un-preconditioned residual either way, so ``rel_tol`` means the same in
    both modes.

    Each step ends with one host read of ``rr > tol2``: the loop is bound
    by its ~20 launches per step, and a read costs one sync, where steps
    run in groups behind a mask would compute the steps past the exit.

    Returns ``(x, rel2, steps)``: ``rel2`` the relative squared residual at
    exit (> rel_tol^2 exactly when the ``max_cg`` cap truncated), ``steps``
    the CG steps taken."""
    r = rhs - apply_fn(x0)
    den = torch.clamp(torch.dot(rhs, rhs), min=torch.finfo(rhs.dtype).tiny)
    tol2 = (rel_tol ** 2) * den

    def prec(res):
        return res if inv_diag is None else res * inv_diag

    x = x0
    z = prec(r)
    p = z
    rz = torch.dot(r, z)
    rr = rz if inv_diag is None else torch.dot(r, r)
    steps = 0
    while steps < max_cg and bool(rr > tol2):
        ap = apply_fn(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = torch.dot(r, z)
        rr = rz_new if inv_diag is None else torch.dot(r, r)
        p = z + (rz_new / rz) * p
        rz = rz_new
        steps += 1
    return x, rr / den, steps


def cg_settings(solver, a_op, n: int, dtype, param: SolverParam):
    """Set the indirect mode's CG settings on ``solver``: ``cg_tol``,
    ``max_cg``, ``setup_tol``, ``setup_max`` and ``inv_diag`` (the
    Jacobi preconditioner from ``a_op.col_sqsum()``, or None), as
    :class:`IndirectSolve` states them."""
    eps_mach = float(torch.finfo(dtype).eps)
    solver.cg_tol = max(min(param.eps_acc * 1e-2, 1e-8), 30.0 * eps_mach)
    solver.max_cg = min(n, 500)
    solver.setup_tol = max(solver.cg_tol * 1e-2, 4.0 * eps_mach)
    solver.setup_max = min(4 * n, 4000)
    if param.cg_precond not in ("auto", "jacobi", "none"):
        raise ValueError(
            f"unknown cg_precond {param.cg_precond!r}; expected "
            "'auto', 'jacobi' or 'none'")
    solver.inv_diag = None
    if param.cg_precond in ("auto", "jacobi"):
        try:
            solver.inv_diag = 1.0 / (1.0 + a_op.col_sqsum().to(dtype))
        except NotImplementedError:
            if param.cg_precond == "jacobi":
                raise


class IndirectSolve:
    """The indirect mode's M-solve on any :class:`LinOp`: warm-started CG
    on I + A^T A. ``ws = (z1, worst_rel2)`` is the last resolvent's
    solution (the next one's initial guess: near the DR fixed point the
    right-hand side barely moves) and the worst relative squared residual
    so far; the host loop calls :meth:`m_solve` in the JAX loop's order,
    so carrying it here is exact.

    The resolvent tolerance stays well below ``eps_acc`` so the DR map is
    effectively exact, floored at the dtype's attainable residual:
    ``cg_tol = max(min(eps_acc 1e-2, 1e-8), 30 eps)``, at most
    ``max_cg = min(n, 500)`` steps (a fixed cap, as in the JAX package).
    The one-time border solve g = M^{-1} h runs tighter (it enters every
    later resolvent): ``max(cg_tol 1e-2, 4 eps)``, ``min(4n, 4000)``
    steps. ``cg_precond`` 'auto' takes Jacobi where the operator has
    ``col_sqsum`` and plain CG where it has not; 'jacobi' raises there."""

    def __init__(self, a_op, n: int, dtype, device, param: SolverParam,
                 ws=None):
        self.a_op = a_op
        cg_settings(self, a_op, n, dtype, param)
        self.ws = ws if ws is not None else (
            torch.zeros(n, dtype=dtype, device=device),
            torch.zeros((), dtype=dtype, device=device))
        self.steps = self.solves = self.setup_steps = 0

    def spd_apply(self, z):
        return z + self.a_op.rmatvec(self.a_op.matvec(z))

    def m_solve(self, r1, r2):
        xw, worst = self.ws
        z1, rel2, steps = _cg(self.spd_apply, r1 - self.a_op.rmatvec(r2), xw,
                              self.cg_tol, self.max_cg, self.inv_diag)
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
        """``SolveResult.diag``: the worst relative resolvent residual of
        the solve against its target (the JAX package's pair), and the CG
        steps of this call's resolvents and of the border's solve."""
        return {"cg_worst_rel": torch.sqrt(self.ws[1]),
                "cg_tol": torch.tensor(self.cg_tol, dtype=self.ws[1].dtype,
                                       device=self.ws[1].device),
                "cg_steps": self.steps, "cg_solves": self.solves,
                "cg_setup_steps": self.setup_steps}


def solve_direct_jit(c, a_op, b, cone: ConeLayout,
                     param: SolverParam = SolverParam(), warm_start=None,
                     resume_state=None) -> SolveResult:
    """The direct-engine solve of ``solve_jit(method='direct')``: ``c``
    (n,) and ``b`` (m,) tensors on the device of the operator ``a_op``
    (the cached solve for a dense A, the indirect mode for any other).
    Never raises on non-convergence; returns a status."""
    with full_f32_matmul():
        return _solve_direct(c, a_op, b, cone, param, warm_start,
                             resume_state)


def _solve_direct(c, a_op, b, cone, param, warm_start, resume_state):
    dtype = torch.promote_types(c.dtype, b.dtype)
    device = a_op.device
    dense = isinstance(a_op, DenseOp)
    c = c.to(dtype)
    b = b.to(dtype)
    a_op = pin_dtype(a_op, dtype)
    n = c.shape[0]
    m = b.shape[0]
    if cone.dim != m:
        raise ValueError(f"cone dim {cone.dim} != m {m}")
    if a_op.shape != (m, n):
        raise ValueError(f"operator shape {a_op.shape} != ({m}, {n})")

    equil_d = equil_e = None
    if param.equil_iters is not None and param.equil_iters > 0:
        from totsu_tpu_torch.solver.scaling import ruiz_equilibrate_op
        a_op, b, c, equil_d, equil_e = ruiz_equilibrate_op(
            a_op, b, c, cone, iters=param.equil_iters)

    eps_zero = param.eps_zero
    eps_inf = effective_eps_inf(param, dtype)
    max_iter = param.bounded_max_iter
    check_period = max(1, param.check_period)
    if param.accel == "halpern":
        # the reflection 2T - I is nonexpansive for the unrelaxed DR map
        if param.relax != 1.0:
            raise ValueError("accel='halpern' requires relax=1.0")
        relax = 1.0
    elif param.accel:
        raise ValueError(
            f"accel {param.accel!r} is not supported by the direct engine"
            " ('halpern' is)")
    else:
        # relax=1.0 is the dataclass default, which for this engine means
        # SCS's over-relaxation 1.5
        relax = float(param.relax) if param.relax != 1.0 else 1.5

    norm_b = torch.linalg.vector_norm(b)
    norm_c = torch.linalg.vector_norm(c)
    # b/c normalization, on by default for this engine: iterate on
    # b/||b||, c/||c||; criteria and solution stay un-normalized
    do_norm = bool(param.normalize) if param.normalize is not None else True
    if do_norm:
        sb = torch.where(norm_b > eps_zero, norm_b, 1.0)
        sc = torch.where(norm_c > eps_zero, norm_c, 1.0)
        b_it, c_it = b / sb, c / sc
    else:
        sb = sc = None
        b_it, c_it = b, c

    # the cold start u0 = v0 = e_tau
    nm1 = n + m + 1
    u0 = torch.zeros(nm1, dtype=dtype, device=device)
    u0[-1] = 1.0
    v0 = u0.clone()
    k_start = 0
    resume_aux = None
    # the resume is unpacked before the cache is built: a checkpoint
    # carries the cache, and a resumed solve skips the O(n^3) build
    if resume_state is not None:
        u0, v0, k_start, resume_aux = _unpack_resume(
            resume_state, "direct", param.accel, device, dtype)
    elif warm_start is not None:
        ws_x, ws_y = warm_start
        if ws_x is not None:
            ws_x = torch.as_tensor(ws_x, dtype=dtype, device=device)
            if equil_e is not None:
                ws_x = ws_x / equil_e
            if do_norm:
                ws_x = ws_x / sb
            u0[:n] = ws_x
        if ws_y is not None:
            ws_y = torch.as_tensor(ws_y, dtype=dtype, device=device)
            if equil_d is not None:
                ws_y = ws_y / equil_d
            if do_norm:
                ws_y = ws_y / sc
            u0[n:n + m] = cone.project(ws_y, dual=True)
        # SCS's warm start of v = (0, s, kappa = 0) with s = Pi_K(b - A x0):
        # at the exact solution (u0, v0) is a fixed point of the DR map
        v0 = torch.zeros(nm1, dtype=dtype, device=device)
        v0[n:n + m] = cone.project(b_it - a_op.matvec(u0[:n]), dual=False)

    aux_c = resume_aux if resume_aux is not None else {}
    if dense:
        amat = a_op.a
        cache = SpdSolve.from_aux(aux_c, dtype) or spd_cache(amat)
        indirect = None

        def spd_solve(rhs):
            z = cache.apply_inv(rhs)
            for _ in range(cache.refine_steps):
                resid = rhs - z - _matmul(amat.T, _matmul(amat, z))
                z = z + cache.apply_inv(resid)
            return z

        def m_solve(r1, r2):
            z1 = spd_solve(r1 - _matmul(amat.T, r2))
            return z1, r2 + _matmul(amat, z1)

        setup_solve = m_solve
        aux = cache.aux()
    else:
        indirect = IndirectSolve(a_op, n, dtype, device, param,
                                 ws=aux_c.get("ws"))
        m_solve, setup_solve = indirect.m_solve, indirect.setup_solve
        aux = {}

    # the Sherman-Morrison border g = M^{-1} h
    h = torch.cat([c_it, b_it])
    if "gh" in aux_c:
        gh, denom = aux_c["gh"], aux_c["denom"]
    else:
        gh = torch.cat(setup_solve(c_it, b_it))
        denom = 1.0 + torch.dot(h, gh)

    def iq_solve(w):
        # solve (I + Q) z = w, z = (z1 (n), z2 (m), ztau)
        wtau = w[-1]
        rhs = w[:n + m] - wtau * h
        t = torch.cat(m_solve(rhs[:n], rhs[n:]))
        z = t - gh * (torch.dot(h, t) / denom)
        ztau = wtau + torch.dot(h, z)
        return torch.cat([z, ztau[None]])

    def proj_c(w):
        # Pi_C with C = R^n x K* x R+
        return torch.cat([w[:n], cone.project(w[n:n + m], dual=True),
                          torch.clamp(w[-1:], min=0.0)])

    def update(u, v):
        ut = iq_solve(u + v)
        ut = u + relax * (ut - u)
        u_new = proj_c(ut - v)
        return u_new, v - ut + u_new

    def t_map(z):
        # the DR operator on z = u~ - v: T(z) = S(2 Pi_C(z) - z) - Pi_C(z)
        # + z, with S the (I + Q) resolvent
        pu = proj_c(z)
        return iq_solve(2.0 * pu - z) - pu + z

    def pair(z):
        # the Moreau pair of z: u = Pi_C(z), v = u - z with <u, v> = 0
        pu = proj_c(z)
        return pu, pu - z

    # the global cap: a resumed loop continues from k_start, and max_iter
    # bounds the iterations of this call
    cap = k_start + max_iter
    pdhg_check = _make_check(a_op, c, b, norm_b, norm_c, sb, sc,
                             param.eps_acc, eps_inf, eps_zero, cap)

    def check(u, v, k):
        # x = u.x, y = u.y, tau = u.tau; the slack s is v's y block
        return pdhg_check((u[:n], u[n:n + m], v[n:n + m], u[-1]), None, k)

    status, crits = initial_status(
        check, u0, v0, k_start, resume_aux,
        warm_start is not None or resume_state is not None, dtype, device)
    aux.update(gh=gh, denom=denom)
    if param.accel == "halpern":
        hal_keys = {"anchor", "ke", "fp_rst", "fp_last", "z"}
        hal_resume = resume_aux if resume_aux is not None \
            and hal_keys <= set(resume_aux) else None
        if hal_resume is not None:
            # exact resume from the raw DR carry saved at the checkpoint
            z0 = hal_resume["z"]
        else:
            # seed z0 = u~_0 - v0, what the first pair step would produce
            # (not u0 - v0 = 0, the trivial fixed point of the embedding)
            z0 = iq_solve(u0 + v0) - v0
        z, k, status, crits, hal_aux = _run_halpern_dr(
            t_map, pair, check, z0, k_start, status, crits, cap,
            check_period, aux=hal_resume)
        u, v = pair(z)
        if hal_resume is not None and _is_terminal(
                hal_resume.get("status", SolverStatus.RUNNING)):
            # a terminal checkpoint's loop exits at once with the raw
            # carry, whose pair is not the one the checkpoint presented:
            # keep the checkpointed pair
            u, v = u0, v0
        aux.update(hal_aux)
    else:
        u, v, k, status, crits, _ = _run_plain(
            update, check, u0, v0, k_start, status, crits, cap,
            check_period)
    if indirect is not None:
        aux["ws"] = indirect.ws
    return _finish((u[:n], u[n:n + m], None, u[-1]), k - k_start, status,
                   crits, eps_zero, sb, sc, equil_d, equil_e,
                   state=_checkpoint(param, "direct", u, v, k, aux, status,
                                     crits),
                   diag=None if indirect is None else indirect.diag())
