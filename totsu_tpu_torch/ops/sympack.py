"""Packed-symmetric-matrix storage and the PSD-cone projections (port of
``totsu_tpu.ops.sympack``).

Upper triangle packed column-major: for ``r <= c`` element ``(r, c)``
lives at ``c*(c+1)/2 + r``. ``scaled=True`` selects the scaled-vec
convention (off-diagonals times sqrt2, so ``||vec(X)|| == ||X||_F``).

The PSD projection of packed blocks (:func:`proj_psd_packed`) has three
methods: ``'eigh'`` (``torch.linalg.eigh``; on a CUDA tensor it
synchronizes the host with the card, as the reference's CUDA backend
does), ``'ns'`` (the scaled Newton-Schulz sign iteration, batched
matmuls in full f32) and ``'jacobi'`` (parallel-order Jacobi: on a CUDA
tensor one launch of the hand-written kernel ``csrc/psd_jacobi.cu``, on
a CPU tensor its plain version, ``ops/jacobi.py``).
"""

import functools
import math
from typing import Optional

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


@functools.lru_cache(maxsize=None)
def _on_device(k: int, what: str, dtype, device: torch.device):
    """The index and weight tensors of :func:`unpack` (``what`` 'gather',
    'unscale') and :func:`pack` ('rows', 'cols', 'scale') on ``device``,
    made once: a copy from the host each call would make every projection
    on the card wait for it."""
    rr, cc = _pack_index(k)
    host = {"gather": lambda: _gather_index(k),
            "unscale": lambda: np.where(np.eye(k, dtype=bool), 1.0,
                                        1.0 / SQRT2),
            "rows": lambda: rr, "cols": lambda: cc,
            "scale": lambda: np.where(rr == cc, 1.0, SQRT2)}[what]()
    return torch.as_tensor(host, dtype=dtype, device=device)


def unpack(v: torch.Tensor, k: int, *, scaled: bool = False) -> torch.Tensor:
    """Packed upper-triangle vector (last axis) -> dense symmetric matrix."""
    m = v[..., _on_device(k, "gather", None, v.device)]
    if scaled:
        m = m * _on_device(k, "unscale", m.dtype, m.device)
    return m


def pack(x: torch.Tensor, *, scaled: bool = False) -> torch.Tensor:
    """Dense symmetric matrix -> packed upper-triangle vector (col-major)."""
    k = x.shape[-1]
    v = x[..., _on_device(k, "rows", None, x.device),
          _on_device(k, "cols", None, x.device)]
    if scaled:
        v = v * _on_device(k, "scale", v.dtype, v.device)
    return v


def _rebuild(vecs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """V diag(w) V^T, batched over leading dims, in full f32 (the
    counterpart of the JAX package's ``Precision.HIGHEST`` einsums)."""
    from totsu_tpu_torch.solver.operator import full_f32_matmul
    with full_f32_matmul():
        return torch.einsum("...ik,...k,...jk->...ij", vecs, w, vecs)


def psd_part(x: torch.Tensor) -> torch.Tensor:
    """Project dense symmetric matrices onto the PSD cone via eigh: keep
    the positive eigenvalues (the reference's ``map_eig`` with an
    ``e > 0`` filter). Batched over leading dims. On a CUDA tensor
    ``torch.linalg.eigh`` synchronizes the host with the card."""
    w, vecs = torch.linalg.eigh(x)
    return _rebuild(vecs, torch.clamp(w, min=0.0))


@functools.lru_cache(maxsize=None)
def _ns_scaled_schedule(l0: float = 5e-6, tol: float = 1e-12,
                        max_steps: int = 40, margin: float = 1e-2):
    """Static per-step scale factors for the scaled Newton-Schulz sign
    iteration, computed on the host exactly as the JAX package does.

    The cubic g(y) = y (3 - y^2)/2 fixes sign but contracts slowly from
    tiny eigenvalues. Rescaling the iterate by s_k > 1 before each cubic
    (safe while s_k * upper <= sqrt(3)) triples the lower edge per step:
    s_k is chosen by bisection to balance the mapped interval ends,
    g(s l) = g(s u), tracking the bracket [l, u] of |eigenvalue| until
    l >= 1 - tol. From l0 = 5e-6 this takes 17 steps. ``margin`` caps s
    at (1 - margin) sqrt(3)/u so that the top edge never maps near
    g(sqrt(3)) = 0, where f32 rounding would become a large relative
    error on the dominant eigenvalue.
    """

    def g(y):
        return y * (3.0 - y * y) / 2.0

    l, u = float(l0), 1.0
    scales = []
    while l < 1.0 - tol and len(scales) < max_steps:
        lo, hi = 1.0, (1.0 - margin) * np.sqrt(3.0) / u
        for _ in range(80):   # bisect on g(s u) - g(s l) (decreasing in s)
            mid = 0.5 * (lo + hi)
            if g(mid * u) > g(mid * l):
                lo = mid
            else:
                hi = mid
        s = 0.5 * (lo + hi)
        ends = (g(s * l), g(s * u))
        peak = 1.0 if (s * l <= 1.0 <= s * u) else max(ends)
        l, u = min(ends), min(peak, 1.0)
        scales.append(s)
    return tuple(scales)


def psd_part_ns(x: torch.Tensor, iters: Optional[int] = None
                ) -> torch.Tensor:
    """PSD projection via the scaled Newton-Schulz matrix-sign iteration,
    batched matmuls only:

        X+ = (X + |X|)/2,   |X| = X sign(X),
        S_0 = X/||X||_F,    S_{k+1} = (s_k S_k)(3I - (s_k S_k)^2)/2

    with the static schedule of :func:`_ns_scaled_schedule` (17 steps).
    Error floor about 5e-6 of the block scale. Every product runs in full
    f32 (no TF32). ``iters`` runs that many unscaled steps instead.
    Batched over leading dims."""
    from totsu_tpu_torch.solver.operator import full_f32_matmul
    norm = torch.sqrt(torch.sum(x * x, dim=(-2, -1), keepdim=True))
    safe = torch.where(norm > 0, norm, 1.0)
    s = x / safe
    scales = ((1.0,) * iters) if iters is not None else _ns_scaled_schedule()
    with full_f32_matmul():
        for sc in scales:
            y = s * sc
            y2 = torch.matmul(y, y)
            s = 0.5 * (3.0 * y - torch.matmul(y, y2))
        # symmetrize |X| = X @ sign(X) against drift
        ax = torch.matmul(x, s)
    ax = 0.5 * (ax + ax.transpose(-1, -2))
    return 0.5 * (x + ax)


def psd_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root via eigh, dropping eigenvalues <= 0
    (``MatBuild::set_sqrt`` semantics). Batched over leading dims."""
    w, vecs = torch.linalg.eigh(x)
    return _rebuild(vecs, torch.sqrt(torch.clamp(w, min=0.0)))


def proj_psd_packed(v: torch.Tensor, *, scaled: bool = True,
                    method: str = "eigh") -> torch.Tensor:
    """PSD-cone projection of packed symmetric vectors (batched).

    ``v``: (..., k(k+1)/2), in the scaled-vec convention by default. The
    reference's ``ConePSD::proj``: unpack, clip negative eigenvalues,
    repack. ``method``: 'eigh' (exact; :func:`psd_part`), 'ns'
    (Newton-Schulz, about 5e-6 error floor; :func:`psd_part_ns`) or
    'jacobi' (parallel-order Jacobi, exact: one kernel launch on a CUDA
    tensor, the plain version on a CPU tensor;
    ``ops/kernels/psd_jacobi.py``)."""
    if method == "jacobi":
        from totsu_tpu_torch.ops.kernels import psd_jacobi
        return psd_jacobi.proj_psd_jacobi(v, scaled=scaled)
    k = order_from_len(v.shape[-1])
    x = unpack(v, k, scaled=scaled)
    if method == "ns":
        part = psd_part_ns(x)
    elif method == "eigh" or not method:
        part = psd_part(x)
    else:
        raise ValueError(f"unknown PSD projection method {method!r}")
    return pack(part, scaled=scaled)
