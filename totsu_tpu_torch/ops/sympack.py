"""Packed-symmetric-matrix storage utilities (port of
``totsu_tpu.ops.sympack``: the pieces the QP reduction and
``MatBuild.set_sqrt`` need).

Upper triangle packed column-major: for ``r <= c`` element ``(r, c)``
lives at ``c*(c+1)/2 + r``. ``scaled=True`` selects the scaled-vec
convention (off-diagonals times sqrt2, so ``||vec(X)|| == ||X||_F``).
The PSD-cone projections wait for ROADMAP §1 item 11.
"""

import functools
import math

import numpy as np
import torch

SQRT2 = math.sqrt(2.0)


def tri_len(k: int) -> int:
    """Length of the packed upper triangle of a (k, k) symmetric matrix."""
    return k * (k + 1) // 2


def order_from_len(sn: int) -> int:
    """Invert ``tri_len``: matrix order k with k(k+1)/2 == sn."""
    k = (math.isqrt(8 * sn + 1) - 1) // 2
    if tri_len(k) != sn:
        raise ValueError(f"{sn} is not a triangular number")
    return k


@functools.lru_cache(maxsize=None)
def _gather_index(k: int) -> np.ndarray:
    """(k, k) int array: position of element (r, c) in the packed vector."""
    idx = np.zeros((k, k), dtype=np.int64)
    for c in range(k):
        for r in range(c + 1):
            p = c * (c + 1) // 2 + r
            idx[r, c] = p
            idx[c, r] = p
    return idx


@functools.lru_cache(maxsize=None)
def _pack_index(k: int):
    """Row/col indices of packed entries in packed (column-major) order."""
    rr = np.zeros(tri_len(k), dtype=np.int64)
    cc = np.zeros(tri_len(k), dtype=np.int64)
    p = 0
    for c in range(k):
        for r in range(c + 1):
            rr[p] = r
            cc[p] = c
            p += 1
    return rr, cc


def unpack(v: torch.Tensor, k: int, *, scaled: bool = False) -> torch.Tensor:
    """Packed upper-triangle vector (last axis) -> dense symmetric matrix."""
    idx = torch.as_tensor(_gather_index(k), device=v.device)
    m = v[..., idx]
    if scaled:
        w = np.where(np.eye(k, dtype=bool), 1.0, 1.0 / SQRT2)
        m = m * torch.as_tensor(w, dtype=m.dtype, device=m.device)
    return m


def pack(x: torch.Tensor, *, scaled: bool = False) -> torch.Tensor:
    """Dense symmetric matrix -> packed upper-triangle vector (col-major)."""
    k = x.shape[-1]
    rr, cc = _pack_index(k)
    v = x[..., torch.as_tensor(rr, device=x.device),
          torch.as_tensor(cc, device=x.device)]
    if scaled:
        w = np.where(rr == cc, 1.0, SQRT2)
        v = v * torch.as_tensor(w, dtype=v.dtype, device=v.device)
    return v


def psd_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root via eigh, dropping eigenvalues <= 0
    (``MatBuild::set_sqrt`` semantics). Batched over leading dims."""
    w, vecs = torch.linalg.eigh(x)
    sw = torch.sqrt(torch.clamp(w, min=0.0))
    return torch.einsum("...ik,...k,...jk->...ij", vecs, sw, vecs)
