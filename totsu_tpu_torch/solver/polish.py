"""Solution polishing: active-set refinement of a converged solve.

Port of ``totsu_tpu.solver.polish``, kept host-side f64 numpy as the JAX
package designed it. First-order engines deliver eps_acc-accurate
solutions; in f32 that is about 1e-3. Polishing recovers
near-machine-precision f64 solutions from them by solving the KKT system
restricted to the active set, the standard SCS "solution polish" trick.
No reference counterpart.

Reachable as ``solve(..., polish=True)`` (``solve_jit`` stays
polish-free: this step is O(one lstsq) after the device solve and wants
f64). The port's tensors come to the host once: A through
:func:`host_matrix` (``to_dense()`` under the :data:`MAX_DENSE_ENTRIES`
guard, then ``.detach().to("cpu", torch.float64).numpy()``), x, y, c and
b the same way (:func:`_host`).

Supported factors: zero / rpos (classic LP active sets), SOC, rotated
SOC and PSD. An RSOC block is Givens-rotated into a plain SOC block
first ((r, s) -> ((r+s)/sqrt2, (r-s)/sqrt2), the involutive map of
ref cone_rotsoc.rs:44-66, applied to the A rows / b entries / dual of
the block): the rotation is orthogonal, so every residual norm is
unchanged and the SOC machinery below applies verbatim; the polished
dual is rotated back on return. This is what lets ``polish=True`` reach
the QP/QCQP epigraph reductions, which always carry a Qr block
(ref qp.rs:299-342).

An SOC block is handled by its three solution regimes:

* slack interior (y = 0)      -> inactive, contributes nothing;
* slack = 0 (y interior)      -> all rows active as equalities;
* both on the boundary        -> slack and dual are anti-proportional
  (s = a(1, w), y = b(1, -w), ||w|| = 1): fix the direction from the
  current dual estimate and impose the linearized activity
  y_hat'(b_blk - A_blk x) = 0 (one equality), restricting the polished
  dual to the ray R+ y_hat.

A PSD block uses eigenspace active-face refinement: at the optimum
S Y = 0, so range(Y) spans the active face. With U the eigenvectors of
the dual estimate mat(Y) above tolerance, impose ``U' mat(S) U = 0``,
one linear equality in x per active pair (i <= j), row =
vec_scaled(sym(u_i u_j')) . A_blk (exact: the scaled-vec convention
makes the packed dot the Frobenius inner product), and restrict the
polished dual to the face, Y = U Gamma U' with Gamma eigen-clipped to
PSD after the fit.

Exp / pow / custom factors cannot be polished; ``solve(polish=True)``
then warns (never a silent no-op) and returns ``polished=False``.
"""

import dataclasses
import functools
import warnings
from typing import Optional

import numpy as np
import torch

from totsu_tpu_torch.solver.cone import (ConeLayout, Factor, ZERO, RPOS,
                                         SOC, RSOC, PSD)
from totsu_tpu_torch.solver.operator import LinOp

#: largest m*n the polish will materialize from a structured LinOp
#: (f64 host array; 5e7 entries = 400 MB). Beyond this the active-set
#: lstsq itself would be the wrong tool anyway.
MAX_DENSE_ENTRIES = 50_000_000


def _host(v) -> np.ndarray:
    """A tensor (any device, dtype) or array-like as a host f64 array."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float64).numpy()
    return np.asarray(v, dtype=np.float64)


def host_matrix(a) -> np.ndarray:
    """A (a tensor, array or any :class:`LinOp`) as a dense host f64
    array. A :class:`LinOp` is materialized once through ``to_dense()``
    under the :data:`MAX_DENSE_ENTRIES` guard: an oversize operator raises
    a ValueError with the limit spelled out."""
    if not isinstance(a, LinOp):
        return _host(a)
    m_, n_ = a.shape
    if m_ * n_ > MAX_DENSE_ENTRIES:
        raise ValueError(
            f"polish materializes A as a dense f64 host array, but "
            f"this operator is {m_} x {n_} = {m_ * n_:,} entries "
            f"(> MAX_DENSE_ENTRIES = {MAX_DENSE_ENTRIES:,}). The "
            "active-set polish is a dense host-side refinement; for "
            "problems at this scale tighten eps_acc / use f64 "
            "instead of polishing.")
    return _host(a.to_dense())


@dataclasses.dataclass
class PolishResult:
    x: np.ndarray
    y: np.ndarray
    polished: bool           # False -> inputs returned unchanged
    pri_res: float           # ||primal violation|| after
    dual_res: float          # ||c + A' y|| after
    obj: float


def _soc_viol(blk):
    """Distance-to-cone proxy for an SOC block (t, v): max(||v|| - t, 0)."""
    t, v = blk[0], blk[1:]
    return max(float(np.linalg.norm(v)) - float(t), 0.0)


def _supported(cone: ConeLayout) -> bool:
    return all(f.kind in (ZERO, RPOS, SOC, RSOC, PSD)
               for f in cone.factors)


def _rsoc_offsets(cone: ConeLayout):
    """Start offsets of every RSOC block of dim >= 2 (dim-1 RSOC is R+)."""
    offs = []
    off = 0
    for f in cone.factors:
        for _ in range(f.count):
            if f.kind == RSOC and f.dim >= 2:
                offs.append(off)
            off += f.dim
    return offs


def _rot_rows(arr, offs):
    """Involutive Givens rotation on rows (off, off+1) of each RSOC block:
    maps RSOC blocks to SOC blocks (and back — its own inverse). Works on
    (m,) vectors and (m, n) matrices; orthogonal, so norms over the
    row space are unchanged."""
    if not offs:
        return arr
    out = np.array(arr, copy=True)
    inv = 1.0 / np.sqrt(2.0)
    for off in offs:
        out[off] = (arr[off] + arr[off + 1]) * inv
        out[off + 1] = (arr[off] - arr[off + 1]) * inv
    return out


def _soc_view(cone: ConeLayout) -> ConeLayout:
    """The layout after RSOC->SOC rotation (dim-1 RSOC edge case = R+,
    ref cone_rotsoc.rs length-1 edge)."""
    facs = []
    for f in cone.factors:
        if f.kind == RSOC:
            facs.append(Factor(SOC if f.dim >= 2 else RPOS, f.dim,
                               f.count))
        else:
            facs.append(f)
    return ConeLayout(tuple(facs))


def _psd_k(dim: int) -> int:
    """Matrix order from packed length dim = k(k+1)/2."""
    return int(round((np.sqrt(8.0 * dim + 1.0) - 1.0) / 2.0))


@functools.lru_cache(maxsize=None)
def _tri_index(k: int):
    """Row and column of each packed entry (column-major upper triangle:
    entry c(c+1)/2 + r is (r, c), r <= c) and whether it is diagonal."""
    rows = np.concatenate([np.arange(j + 1) for j in range(k)])
    cols = np.concatenate([np.full(j + 1, j) for j in range(k)])
    return rows, cols, rows == cols


def _unpack_np(v, k):
    """Scaled-vec packed (col-major upper triangle) -> dense sym, f64.
    The JAX package's entry-by-entry loop as index arrays: each entry the
    same division, so the same bits."""
    rows, cols, diag = _tri_index(k)
    v = np.asarray(v, dtype=np.float64)
    vals = np.where(diag, v, v / np.sqrt(2.0))
    m = np.zeros((k, k))
    m[rows, cols] = vals
    m[cols, rows] = vals
    return m


def _pack_np(m):
    """Dense symmetric -> scaled-vec packed, f64 (the upper triangle read
    as the JAX package's loop reads it, each entry the same product)."""
    rows, cols, diag = _tri_index(m.shape[0])
    return m[rows, cols] * np.where(diag, 1.0, np.sqrt(2.0))


def polish(res, c, a, b, cone: ConeLayout,
           active_tol: Optional[float] = None) -> PolishResult:
    """Refine ``res`` (a :class:`SolveResult`; host-side, f64). Accepts
    the polished point only if it improves the worst KKT residual;
    otherwise returns the original.

    ``a`` may be a tensor, an array or any :class:`LinOp` (blocked-ELL,
    stacked, matrix-free): it is materialized once by :func:`host_matrix`
    under the :data:`MAX_DENSE_ENTRIES` size guard (the active-set lstsq
    is a dense host computation by design); oversize operators raise a
    ValueError with the limit spelled out."""
    c = _host(c)
    a = host_matrix(a)
    b = _host(b)
    x = _host(res.x)
    y = _host(res.y)
    m, n = a.shape

    # RSOC blocks: rotate the problem's rows into SOC coordinates once —
    # the rotation is orthogonal and involutive, so residual norms are
    # unchanged and rotating the returned dual back at the end is exact
    rsoc_offs = _rsoc_offsets(cone)
    y_orig = y
    if rsoc_offs:
        a = _rot_rows(a, rsoc_offs)
        b = _rot_rows(b, rsoc_offs)
        y = _rot_rows(y, rsoc_offs)
        cone = _soc_view(cone)

    def residuals(xx, yy):
        slack = b - a @ xx
        viol = np.zeros(m)
        off = 0
        for f in cone.factors:
            for _ in range(f.count):
                seg = slice(off, off + f.dim)
                if f.kind == ZERO:
                    viol[seg] = slack[seg]
                elif f.kind == RPOS:
                    viol[seg] = np.minimum(slack[seg], 0.0)
                elif f.kind == SOC:
                    viol[off] = _soc_viol(slack[seg])
                elif f.kind == PSD:
                    k = _psd_k(f.dim)
                    wmin = float(np.linalg.eigvalsh(
                        _unpack_np(slack[seg], k))[0])
                    viol[off] = max(-wmin, 0.0)
                off += f.dim
        pri = float(np.linalg.norm(viol))
        dual = float(np.linalg.norm(c + a.T @ yy))
        return pri, dual

    pri0, dual0 = residuals(x, y)
    # base/best stay in the ROTATED coordinates while iterating (the
    # re-linearization passes feed best.y back against the rotated a/b);
    # the final return swaps in / rotates back to the original dual
    base = PolishResult(x=x, y=y, polished=False, pri_res=pri0,
                        dual_res=dual0, obj=float(c @ x))
    if not _supported(cone) or m == 0:
        if not _supported(cone):
            bad = sorted({f.kind for f in cone.factors
                          if f.kind not in (ZERO, RPOS, SOC, RSOC, PSD)})
            # loud no-op: the caller asked for refinement
            # it cannot have; polished=False alone is too easy to miss
            warnings.warn(
                f"polish does not support cone factors {bad}; returning "
                "the unpolished solution (polished=False)",
                RuntimeWarning, stacklevel=2)
        return dataclasses.replace(base, y=y_orig)

    # Active-set identification at eps_acc accuracy is fuzzy: a single
    # tolerance routinely misses a constraint of the optimal basis (then
    # the restricted lstsq returns a non-vertex minimum-norm point and the
    # candidate is rejected). Try a small tolerance ladder plus the
    # SCS-style magnitude rule (active iff y_i > slack_i); then
    # RE-LINEARIZE from the best candidate even when its first pass is
    # not yet better than the input — SOC/RSOC face directions and PSD
    # active faces are estimated from the CURRENT dual, so the first
    # pass only reaches that estimate's accuracy (on the QP epigraph the
    # first pass measurably lands at ~3x the input residual and was
    # formerly rejected outright); iterating from the candidate
    # converges the face like a Newton step (quadratic — a few passes
    # reach f64 roundoff from an eps_acc ~ 1e-3 start). Acceptance
    # against the input happens only at the end.
    def grid_for(p):
        if active_tol is not None:
            return [active_tol]
        t0 = 10.0 * max(p, 1e-9)
        return [0.1 * t0, t0, 10.0 * t0, None]  # None = y > slack rule

    best = base
    work_x, work_y = x, y
    work_res = np.inf
    for _ in range(4):
        slack_w = b - a @ work_x
        cands = [_polish_once(c, a, b, cone, work_x, work_y, slack_w,
                              tol, residuals, m)
                 for tol in grid_for(max(pri0, work_res if
                                         np.isfinite(work_res) else pri0))]
        cands = [cd for cd in cands if cd is not None]
        if not cands:
            break
        cand = min(cands, key=lambda cd: max(cd.pri_res, cd.dual_res))
        cres = max(cand.pri_res, cand.dual_res)
        if cres < max(best.pri_res, best.dual_res):
            best = cand
        if cres >= work_res:          # no progress between passes
            break
        work_x, work_y, work_res = cand.x, cand.y, cres
    # Newton closer for boundary-SOC layouts (QP/QCQP epigraphs): the
    # linear face passes contract only ~0.8x there — see _newton_refine
    for sx, sy in ((work_x, work_y), (x, y)):
        nt = _newton_refine(c, a, b, cone, sx, sy,
                            10.0 * max(pri0, 1e-9), residuals)
        if nt is not None and max(nt.pri_res, nt.dual_res) < \
                max(best.pri_res, best.dual_res):
            best = nt
            break
    if not best.polished:
        return dataclasses.replace(best, y=y_orig)
    if rsoc_offs:
        # rotate the polished dual back to the original coordinates
        best = dataclasses.replace(best, y=_rot_rows(best.y, rsoc_offs))
    return best


def _newton_refine(c, a, b, cone, x, y, tol, residuals):
    """Newton iteration on the active-set KKT system — the closer for
    layouts whose blocks are zero / rpos / SOC (incl. rotated-to-SOC).

    The linear active-face pass stalls on problems where a boundary SOC
    block must pin x through its *curved* surface (the QP epigraph: the
    face direction error only contracts ~0.8x per re-linearization —
    measured). The optimum instead solves the square nonlinear system

        F1 = c + R' lam + sum_j beta_j grad g_j(x) = 0   (stationarity)
        F2 = R x - r = 0                                 (active rows)
        F3 = g_j(x) = 0                                  (SOC boundary)

    with g_j(x) = ||s_tail|| - s_head of block j's slack, R the active
    zero/rpos rows, and the block dual mu_j = beta_j (1, -s_tail/
    ||s_tail||) folded in via its ray form. Newton on F converges
    quadratically; 6 full steps reach f64 roundoff from an eps ~ 1e-3
    start. Returns a PolishResult candidate or None (no boundary blocks /
    unsupported factor kinds present)."""
    m, nx = a.shape
    if any(f.kind not in (ZERO, RPOS, SOC) for f in cone.factors):
        return None
    slack = b - a @ x

    rows_r = []            # active zero/rpos/soc-interior row indices
    rpos_pos = []          # positions in rows_r that need lam >= 0
    blocks = []            # (seg, beta0) boundary SOC blocks
    off = 0
    for f in cone.factors:
        for _ in range(f.count):
            seg = slice(off, off + f.dim)
            if f.kind == ZERO:
                rows_r.extend(range(off, off + f.dim))
            elif f.kind == RPOS:
                for i in range(off, off + f.dim):
                    if y[i] > abs(slack[i]) or abs(slack[i]) <= tol:
                        rpos_pos.append(len(rows_r))
                        rows_r.append(i)
            else:                                    # SOC
                y_blk = y[seg]
                s_blk = slack[seg]
                ny = float(np.linalg.norm(y_blk))
                ns = float(np.linalg.norm(s_blk))
                if ny <= 1e-12 or (ny <= ns and
                                   _soc_viol(s_blk) <= 1e-12):
                    pass                             # inactive
                elif ns <= tol and f.dim <= nx:
                    rows_r.extend(range(off, off + f.dim))
                else:
                    blocks.append((off, f.dim, max(float(y_blk[0]),
                                                   1e-12)))
            off += f.dim
    if not blocks:
        return None                   # the linear pass already covers it
    r_mat = a[rows_r] if rows_r else np.zeros((0, nx))
    r_rhs = b[rows_r] if rows_r else np.zeros((0,))
    p = len(rows_r)
    nb = len(blocks)

    lam = np.array([y[i] for i in rows_r])
    beta = np.array([b0 for (_, _, b0) in blocks])
    xn = x.copy()
    for _ in range(8):
        grads = np.zeros((nb, nx))
        gvals = np.zeros(nb)
        hess = np.zeros((nx, nx))
        ok = True
        for j, (o, d, _) in enumerate(blocks):
            a_h = a[o]
            a_t = a[o + 1:o + d]
            s = b[o:o + d] - a[o:o + d] @ xn
            nst = float(np.linalg.norm(s[1:]))
            if nst <= 1e-14:
                ok = False
                break
            sh = s[1:] / nst
            gvals[j] = nst - s[0]
            grads[j] = a_h - sh @ a_t
            proj = a_t - np.outer(sh, sh @ a_t)      # (I - sh sh') A_t
            hess += beta[j] * (a_t.T @ proj) / nst
        if not ok:
            break
        f1 = c + (r_mat.T @ lam if p else 0.0) + grads.T @ beta
        f2 = (r_mat @ xn - r_rhs) if p else np.zeros((0,))
        jac = np.zeros((nx + p + nb, nx + p + nb))
        jac[:nx, :nx] = hess
        jac[:nx, nx:nx + p] = r_mat.T
        jac[:nx, nx + p:] = grads.T
        jac[nx:nx + p, :nx] = r_mat
        jac[nx + p:, :nx] = grads
        rhs = -np.concatenate([f1, f2, gvals])
        if max(np.abs(rhs).max(), 0.0) < 1e-15:
            break
        step, *_ = np.linalg.lstsq(jac, rhs, rcond=None)
        xn = xn + step[:nx]
        lam = lam + step[nx:nx + p]
        beta = beta + step[nx + p:]

    # rebuild the dual from the multipliers (rpos/ray signs clipped)
    y_n = np.zeros(m)
    for pos, i in enumerate(rows_r):
        y_n[i] = max(lam[pos], 0.0) if pos in set(rpos_pos) else lam[pos]
    for j, (o, d, _) in enumerate(blocks):
        s = b[o:o + d] - a[o:o + d] @ xn
        nst = float(np.linalg.norm(s[1:]))
        if nst > 1e-14:
            bj = max(float(beta[j]), 0.0)
            y_n[o] = bj
            y_n[o + 1:o + d] = -bj * s[1:] / nst
    pri1, dual1 = residuals(xn, y_n)
    return PolishResult(x=xn, y=y_n, polished=True, pri_res=pri1,
                        dual_res=dual1, obj=float(c @ xn))


def _polish_once(c, a, b, cone, x, y, slack, active_tol, residuals, m):
    """One active-set guess -> polished candidate (or None)."""

    def rpos_active(i):
        if active_tol is None:
            return y[i] > abs(slack[i])
        return abs(slack[i]) <= active_tol or y[i] >= active_tol

    def blk_tol():
        return 1e-9 if active_tol is None else active_tol

    # primal active rows (equalities for the lstsq) and the dual basis:
    # y = B @ gamma with one column per free scalar / per SOC ray
    prim_rows = []       # list of (row_vector over x, rhs)
    basis_cols = []      # columns of B (length m)
    ray_cols = []        # indices into gamma that must stay >= 0 (rays)
    rpos_rows = []       # y indices to clip at 0 after the fit
    psd_blocks = []      # (seg, U, [gamma col indices]) for the PSD clip

    off = 0
    for f in cone.factors:
        for _ in range(f.count):
            seg = slice(off, off + f.dim)
            if f.kind == ZERO:
                for i in range(off, off + f.dim):
                    prim_rows.append(i)
                    e = np.zeros(m)
                    e[i] = 1.0
                    basis_cols.append(e)
            elif f.kind == RPOS:
                for i in range(off, off + f.dim):
                    if rpos_active(i):
                        prim_rows.append(i)
                        e = np.zeros(m)
                        e[i] = 1.0
                        basis_cols.append(e)
                        rpos_rows.append(len(basis_cols) - 1)
            elif f.kind == SOC:
                s_blk = slack[seg]
                y_blk = y[seg]
                ny = float(np.linalg.norm(y_blk))
                ns = float(np.linalg.norm(s_blk))
                if ny <= blk_tol() or (active_tol is None and ny <= ns):
                    pass                       # inactive block
                elif ns <= blk_tol():
                    # slack pinned at 0: all rows equalities, dual free
                    for i in range(off, off + f.dim):
                        prim_rows.append(i)
                        e = np.zeros(m)
                        e[i] = 1.0
                        basis_cols.append(e)
                else:
                    # boundary: s and y are anti-proportional, so the
                    # active face is the RAY s = s_head (1, w) with
                    # w = -y_tail/||y_tail|| — imposing s_tail =
                    # s_head w is dim-1 equalities. (A single supporting-
                    # hyperplane row under-determines curved problems:
                    # the QP epigraph's RSOC block alone must pin all of
                    # x — measured pri stall at ~1e-3 with one row.)
                    d = y_blk / ny
                    nyt = float(np.linalg.norm(y_blk[1:]))
                    if nyt > blk_tol():
                        w = -y_blk[1:] / nyt
                        for i in range(1, f.dim):
                            vrow = np.zeros(f.dim)
                            vrow[i] = 1.0
                            vrow[0] = -w[i - 1]
                            prim_rows.append(("soc", seg, vrow))
                    else:
                        # dual at the apex: direction undefined, fall
                        # back to the single hyperplane linearization
                        prim_rows.append(("soc", seg, d))
                    col = np.zeros(m)
                    col[seg] = d
                    basis_cols.append(col)
                    ray_cols.append(len(basis_cols) - 1)
            elif f.kind == PSD:
                # eigenspace active face from the complementarity gap
                # W = mat(Y) - mat(S): positive eigendirections are active
                # (the matrix form of the rpos "y_i > slack_i" rule). W
                # moves with the polished x, so the re-linearization
                # passes converge the face — identifying from Y alone is
                # self-reproducing (Y_p is built exactly rank-r on U) and
                # stalls at the first estimate's accuracy.
                k = _psd_k(f.dim)
                wmat = _unpack_np(y[seg], k) - _unpack_np(slack[seg], k)
                wy, q = np.linalg.eigh(wmat)
                act = wy > 0.0
                r = int(np.sum(act))
                if r > 0:
                    u = q[:, act]                      # (k, r)
                    cols_here = []
                    for jj in range(r):
                        for ii in range(jj + 1):
                            mt = np.outer(u[:, ii], u[:, jj])
                            d = _pack_np(0.5 * (mt + mt.T))
                            prim_rows.append(("soc", seg, d))
                            col = np.zeros(m)
                            col[seg] = d
                            basis_cols.append(col)
                            cols_here.append(len(basis_cols) - 1)
                    psd_blocks.append((seg, u, cols_here))
            off += f.dim

    if not basis_cols:
        return None

    # assemble the primal equality system
    rows = []
    rhs = []
    for r in prim_rows:
        if isinstance(r, tuple):
            _, seg, d = r
            rows.append(d @ a[seg])
            rhs.append(float(d @ b[seg]))
        else:
            rows.append(a[r])
            rhs.append(float(b[r]))
    a_act = np.asarray(rows)
    b_act = np.asarray(rhs)

    x_p, *_ = np.linalg.lstsq(a_act, b_act, rcond=None)

    bmat = np.stack(basis_cols, axis=1)        # (m, K)
    gam, *_ = np.linalg.lstsq(a.T @ bmat, -c, rcond=None)
    for k in rpos_rows:
        gam[k] = max(gam[k], 0.0)
    for k in ray_cols:
        gam[k] = max(gam[k], 0.0)
    y_p = bmat @ gam
    # PSD blocks: rebuild Gamma on the active face from the fitted
    # coefficients (basis sym(u_i u_j') has Frobenius dot 1/2 off-face-
    # diagonal), clip it to PSD, re-project the dual onto the face
    for seg, u, cols_here in psd_blocks:
        r = u.shape[1]
        gmat = np.zeros((r, r))
        idx = 0
        for jj in range(r):
            for ii in range(jj + 1):
                gval = gam[cols_here[idx]]
                if ii == jj:
                    gmat[ii, ii] = gval
                else:
                    gmat[ii, jj] = gmat[jj, ii] = 0.5 * gval
                idx += 1
        wg, qg = np.linalg.eigh(gmat)
        gpsd = (qg * np.maximum(wg, 0.0)) @ qg.T
        y_p[seg] = _pack_np(u @ gpsd @ u.T)

    pri1, dual1 = residuals(x_p, y_p)
    return PolishResult(x=x_p, y=y_p, polished=True, pri_res=pri1,
                        dual_res=dual1, obj=float(c @ x_p))
