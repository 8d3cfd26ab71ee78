"""Batched symmetric eigendecomposition by parallel-order cyclic Jacobi
(port of ``totsu_tpu.ops.jacobi``), in plain PyTorch.

This is the plain version of kernel J (``csrc/psd_jacobi.cu``, wrapped by
``ops/kernels/psd_jacobi.py``): the wrapper runs it for CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card. It computes
what the JAX code computes, step for step:

* a round-robin tournament schedule (:func:`_schedule`) picks k/2
  disjoint pivot pairs per round; k-1 rounds touch every off-diagonal pair
  once per sweep (Brent & Luk 1985);
* all rotations of a round form one orthogonal ``J = diag(c) + s_row P``
  (P the partner permutation), applied as two permutations and
  elementwise multiply-adds:

      (A J)[i, b]   = c_b A[i, b] - s_b A[i, partner[b]]
      (J^T B)[a, b] = c_a B[a, b] - s_a B[partner[a], b]

  (the minus signs use ``s[partner[r]] == -s_r``, exact in floating point
  because the Schur tangent is odd and A is kept exactly symmetric);
* per-row rotation parameters from the symmetric Schur formulas (Golub &
  Van Loan 8.4): ``theta_r = (a_mm - a_rr) / (2 a_rm)``, ``t =
  sign(theta)/(|theta| + sqrt(theta^2+1))``, ``c = 1/sqrt(t^2+1)``, ``s =
  t c``.

Eagerly each round is about 40 launches, so on the card the projection
runs as one launch of kernel J instead; this module is what the CPU runs
and what the kernel is checked against.
"""

import functools
from typing import Optional

import numpy as np
import torch

from totsu_tpu_torch.ops.sympack import _rebuild


@functools.lru_cache(maxsize=None)
def _schedule(k: int):
    """Tuple of k-1 partner-index tuples: round-robin tournament over k
    players (k even). Entry r gives each row's pivot partner in round r."""
    assert k % 2 == 0
    players = list(range(k))
    rounds = []
    for _ in range(k - 1):
        part = [0] * k
        half = k // 2
        for i in range(half):
            a, b = players[i], players[k - 1 - i]
            part[a], part[b] = b, a
        rounds.append(tuple(part))
        # rotate all but the first player
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


def _round(a, v, partner, lt_sign, eps, diag_idx):
    """One parallel-Jacobi round: rotate all disjoint pairs of ``partner``
    (a (k,) index tensor, an involution); ``lt_sign`` (k,) is +1 where r <
    partner[r], else -1: the antisymmetric 45-degree tie-break when the
    diagonals are equal."""
    d = a[..., diag_idx, diag_idx]                    # (..., k) a_rr
    d_part = d[..., partner]                          # a_mm
    a_rm = a[..., diag_idx, partner]                  # a_r,partner[r]
    # symmetric Schur; skip (identity rotation) when the pivot is ~zero
    small = a_rm.abs() <= eps * torch.maximum(
        torch.sqrt(d.abs() * d_part.abs()), eps)
    safe_arm = torch.where(small, 1.0, a_rm)
    theta = (d_part - d) / (2.0 * safe_arm)
    t = torch.sign(theta) / (theta.abs() + torch.sqrt(theta * theta + 1.0))
    # equal-diagonal pivots need a 45-degree rotation whose sign is
    # antisymmetric between the two rows of a pair (else J is singular)
    t = torch.where(theta == 0.0, lt_sign, t)
    c = torch.rsqrt(t * t + 1.0)
    s = t * c
    c = torch.where(small, 1.0, c)
    s = torch.where(small, 0.0, s)

    cc = c[..., None, :]
    sc = s[..., None, :]
    b1 = a * cc - a[..., :, partner] * sc            # A J
    a2 = b1 * c[..., :, None] - b1[..., partner, :] * s[..., :, None]
    # keep exactly symmetric against roundoff drift (the next round reads
    # its pivots from both triangles)
    a2 = 0.5 * (a2 + a2.transpose(-1, -2))
    v2 = v * cc - v[..., :, partner] * sc            # V J
    return a2, v2


def jacobi_eigh(a: torch.Tensor, sweeps: int = 10, eps: float = 0.0):
    """Eigendecomposition of batched symmetric matrices by parallel
    Jacobi: ``(w, v)`` with ``a ~= v @ diag(w) @ v.T``, as
    ``torch.linalg.eigh`` but with the eigenvalues NOT sorted (in the JAX
    package's order). ``a`` (..., k, k) is read symmetrically (its
    symmetric part). ``sweeps`` full sweeps of k-1 rounds; ``eps`` guards
    the rotation against ~zero pivots (0: exact zero-pivot skip only)."""
    k = a.shape[-1]
    # exact symmetry is load-bearing: s[partner[r]] == -s_r needs a[p, q]
    # == a[q, p] bit for bit
    a = 0.5 * (a + a.transpose(-1, -2))
    kp = k + (k % 2)  # pad odd orders with one decoupled zero row/col
    if kp != k:
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    sched = _schedule(kp)
    dev, dt = a.device, a.dtype
    rounds = [(torch.as_tensor(p, device=dev),
               torch.as_tensor(np.where(np.arange(kp) < np.asarray(p),
                                        1.0, -1.0), dtype=dt, device=dev))
              for p in sched]
    epsv = torch.as_tensor(eps, dtype=dt, device=dev)
    diag_idx = torch.arange(kp, device=dev)
    v = torch.eye(kp, dtype=dt, device=dev).expand(a.shape).clone()
    for _ in range(sweeps):
        for partner, lt in rounds:
            a, v = _round(a, v, partner, lt, epsv, diag_idx)
    w = a[..., diag_idx, diag_idx]
    if kp != k:
        w = w[..., :k]
        v = v[..., :k, :k]
    return w, v


def sweeps_for(k: int, sweeps: Optional[int] = None) -> int:
    """The sweep count of :func:`psd_part_jacobi`: ``sweeps`` when given,
    else 10 up to k = 128 and 14 up to k = 256 (the JAX package's rule);
    past 256 an explicit count is required."""
    if sweeps is not None:
        return int(sweeps)
    if k > 256:
        raise ValueError(
            f"psd_part_jacobi auto-sweeps is unmeasured for k={k} > "
            "256; pass sweeps explicitly (or use method='eigh')")
    return 10 if k <= 128 else 14


def psd_part_jacobi(x: torch.Tensor, sweeps: Optional[int] = None
                    ) -> torch.Tensor:
    """PSD projection via :func:`jacobi_eigh`: clip negative eigenvalues,
    rebuild V diag(max(w, 0)) V^T (the reference's ``ConePSD::proj`` map
    ``e -> e if e > 0``). ``sweeps`` as in :func:`sweeps_for`."""
    w, v = jacobi_eigh(x, sweeps=sweeps_for(x.shape[-1], sweeps))
    return _rebuild(v, torch.clamp(w, min=0.0))
