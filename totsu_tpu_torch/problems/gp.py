"""Geometric program -> conic form (exponential cones).

Port of ``totsu_tpu.problems.gp``. A GP in posynomial form is

    minimize    f_0(x)
    subject to  f_i(x) <= 1,  i = 1..p,       x > 0,
    where f(x) = sum_k c_k * prod_j x_j^(A_kj),   c_k > 0.

The change of variables y = log x makes every posynomial a log-sum-exp,
log f = lse_k(A_k y + log c_k), and the GP becomes min t s.t. lse_0 <= t,
lse_i <= 0. Each log-sum-exp epigraph ``lse_k(z) <= t`` is exactly

    sum_k u_k <= 1,   (z_k - t, 1, u_k) in K_exp   (e^{z_k - t} <= u_k),

one exp-cone block per monomial plus one R+ row per posynomial (the
reduction CVXPY/ECOS/SCS use for GPs).

Conic variables: z = [y (n) | t (1) | u (total monomials)]; slack
convention s = b - A z in K.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from totsu_tpu_torch.problems.base import ConicProblem
from totsu_tpu_torch.solver import cone as cones
from totsu_tpu_torch.solver.operator import DenseOp, target_device


def gp(term_c: Sequence, term_a: Sequence,
       eq_c: Optional[Sequence] = None,
       eq_a: Optional[Sequence] = None, *, device=None,
       dtype=torch.float64) -> Tuple[ConicProblem, dict]:
    """Build the conic form of a geometric program.

    * ``term_c``: list (one per posynomial, entry 0 = objective) of
      positive coefficient vectors ``c_k``;
    * ``term_a``: matching list of exponent matrices, each ``(K_i, n)``;
    * ``eq_c`` / ``eq_a``: optional monomial *equalities* g(x) = 1
      (coefficient scalar + exponent row each), affine in y:
      ``a^T y + log c = 0``.

    The data is assembled in numpy (f64) and lands as ``dtype`` tensors on
    ``device`` (default the CUDA card). Returns ``(ConicProblem, meta)``;
    after ``res = prob.solve(...)``, the positive solution is
    ``exp(res.x[:n])`` and the optimal value ``exp(res.x[meta['t']])``.
    """
    term_c = [np.asarray(ci, dtype=float) for ci in term_c]
    term_a = [np.asarray(ai, dtype=float) for ai in term_a]
    if len(term_c) != len(term_a):
        raise ValueError("term_c and term_a must pair up per posynomial")
    n = term_a[0].shape[1]
    for ci, ai in zip(term_c, term_a):
        if (ci <= 0).any():
            raise ValueError("posynomial coefficients must be positive")
        if ai.shape[0] != ci.shape[0]:
            raise ValueError("coefficients/exponent-rows count mismatch")
        if ai.shape[1] != n:
            raise ValueError(
                f"exponent matrix has {ai.shape[1]} columns, expected {n}")
    n_pos = len(term_c)
    ks = np.asarray([ci.shape[0] for ci in term_c])
    n_u = int(ks.sum())
    nv = n + 1 + n_u            # y | t | u
    it = n                      # epigraph variable index
    iu0 = n + 1

    # ---- zero cone: monomial equalities a^T y = -log c
    eq_c = [] if eq_c is None else list(eq_c)
    eq_a = [] if eq_a is None else [np.asarray(a, dtype=float) for a in eq_a]
    if len(eq_c) != len(eq_a):
        raise ValueError("eq_c and eq_a must pair up per monomial equality")
    n_eq = len(eq_c)
    for cv, av in zip(eq_c, eq_a):
        if av.shape != (n,):
            raise ValueError(
                f"equality exponent row has shape {av.shape}, expected ({n},)")
        if float(cv) <= 0:
            raise ValueError("monomial coefficients must be positive")
    a_eq = np.zeros((n_eq, nv))
    b_eq = np.zeros(n_eq)
    if n_eq:
        a_eq[:, :n] = np.stack(eq_a)
        b_eq = -np.log(np.asarray(eq_c, dtype=float))

    # ---- rpos: one budget row per posynomial, 1 - sum_k u_k >= 0
    pos_of_mono = np.repeat(np.arange(n_pos), ks)       # (n_u,)
    a_pos = np.zeros((n_pos, nv))
    a_pos[pos_of_mono, iu0 + np.arange(n_u)] = 1.0
    b_pos = np.ones(n_pos)

    # ---- exp cones: (A_k y + log c_k [- t for the objective], 1, u_k)
    # rows per monomial interleave as (s1, s2, s3)
    a_all = np.concatenate(term_a, axis=0)              # (n_u, n)
    c_all = np.concatenate(term_c)                      # (n_u,)
    a_exp = np.zeros((n_u, 3, nv))
    a_exp[:, 0, :n] = -a_all                            # s1 = A_k y + ...
    a_exp[:, 0, it] = (pos_of_mono == 0).astype(float)  # ... - t (objective)
    a_exp[np.arange(n_u), 2, iu0 + np.arange(n_u)] = -1.0   # s3 = u_k
    b_exp = np.zeros((n_u, 3))
    b_exp[:, 0] = np.log(c_all)
    b_exp[:, 1] = 1.0                                   # s2 = 1

    rows = np.concatenate([a_eq, a_pos, a_exp.reshape(3 * n_u, nv)])
    bs = np.concatenate([b_eq, b_pos, b_exp.reshape(3 * n_u)])

    c_obj = np.zeros(nv)
    c_obj[it] = 1.0                          # minimize t = log f_0(x)
    layout = cones.ConeLayout([
        cones.zero(n_eq), cones.rpos(n_pos),
        cones.expc(count=n_u)])
    dev = target_device(device)

    def put(x):
        return torch.from_numpy(x).to(device=dev, dtype=dtype).contiguous()

    prob = ConicProblem(c=put(c_obj), a=DenseOp(put(rows)), b=put(bs),
                        cone=layout)
    return prob, {"n": n, "t": it, "u0": iu0}
