"""Level-set contour extraction (marching squares), vectorized: the
port's own copy of ``totsu_tpu.utils.contour`` (numpy only).

The reference ships ``utils2::ContourSeries`` (examples/utils2/src/
contour_series.rs:5-147): a plotters series that walks every grid cell,
finds sign changes of ``f(x, y) - thr`` along cell edges and emits line
segments with bilinear (|z|-weighted) edge interpolation — used by
svm_qp to draw the kernel-SVM decision boundary. This module provides
the same capability as a library function, re-derived array-first: one
vectorized marching-squares pass over the whole grid (numpy, no Python
per-cell loop) instead of the reference's per-cell iterator.

Conventions match the reference where they are visible:

* crossing position on an edge with end values z0, z1 (opposite signs)
  is ``alpha * p0 + (1 - alpha) * p1`` with ``alpha = |z1| / (|z0| +
  |z1|)`` (contour_series.rs ``bilinear``, :18-28) — i.e. exact for
  affine f along the edge;
* a zero denominator falls back to the midpoint (ditto);
* the level is a threshold subtracted from z (``thr``, default 0).

Beyond the reference, saddle cells (both diagonals crossing) are
disambiguated with the cell-center mean instead of emitting an arbitrary
pairing, and ``chain_segments`` stitches segments into polylines.
"""

from typing import Callable, List, Sequence

import numpy as np

# Edges of a cell: 0=bottom, 1=right, 2=top, 3=left. For each 4-bit
# corner-sign code (b0=(x0,y0), b1=(x1,y0), b2=(x0,y1), b3=(x1,y1);
# bit set = z >= level) the table lists up to two segments as edge-index
# pairs; -1 = unused. Codes 6/9 (diagonal saddles) are resolved at
# runtime from the cell-center sign.
_SEGS = -np.ones((16, 2, 2), dtype=np.int8)
for _code, _pairs in {
        1: [(3, 0)], 14: [(3, 0)],
        2: [(0, 1)], 13: [(0, 1)],
        3: [(3, 1)], 12: [(3, 1)],
        4: [(3, 2)], 11: [(3, 2)],
        5: [(0, 2)], 10: [(0, 2)],
        7: [(2, 1)], 8: [(2, 1)],
}.items():
    for _i, _p in enumerate(_pairs):
        _SEGS[_code, _i] = _p
# saddles, keyed by (code, center >= level)
_SADDLE = {
    (6, True): [(0, 3), (2, 1)], (6, False): [(0, 1), (2, 3)],
    (9, True): [(0, 1), (2, 3)], (9, False): [(0, 3), (2, 1)],
}


def _edge_alpha(z0, z1):
    """|z|-weighted interpolation weight of the first endpoint
    (contour_series.rs:18-28): alpha = |z1| / (|z0| + |z1|)."""
    denom = np.abs(z0) + np.abs(z1)
    safe = np.where(denom > 0, denom, 1.0)
    return np.where(denom > 0, np.abs(z1) / safe, 0.5)


def contour_segments(xs, ys, z, level: float = 0.0) -> np.ndarray:
    """Extract level-set line segments from gridded samples.

    ``xs`` (nx,), ``ys`` (ny,): grid coordinates; ``z`` (ny, nx): samples
    with ``z[j, i] = f(xs[i], ys[j])``. Returns an (S, 2, 2) float array
    of segments ``[[x_a, y_a], [x_b, y_b]]`` tracing ``f = level``.
    """
    xs = np.asarray(xs, dtype=float)
    ys = np.asarray(ys, dtype=float)
    z = np.asarray(z, dtype=float) - level
    ny, nx = z.shape
    if (nx, ny) != (xs.size, ys.size):
        raise ValueError(f"z shape {z.shape} != (len(ys), len(xs)) = "
                         f"({ys.size}, {xs.size})")
    if nx < 2 or ny < 2:
        return np.zeros((0, 2, 2))

    z00, z10 = z[:-1, :-1], z[:-1, 1:]
    z01, z11 = z[1:, :-1], z[1:, 1:]
    s = (z >= 0)
    code = (s[:-1, :-1].astype(np.int8)
            + 2 * s[:-1, 1:] + 4 * s[1:, :-1] + 8 * s[1:, 1:])

    x0 = xs[None, :-1]
    x1 = xs[None, 1:]
    y0 = ys[:-1, None]
    y1 = ys[1:, None]
    # crossing point on each of the 4 edges of every cell (valid only
    # where that edge has a sign change — the table never reads others)
    pts = np.empty((ny - 1, nx - 1, 4, 2))
    a = _edge_alpha(z00, z10)                       # bottom: (x0,y0)-(x1,y0)
    pts[..., 0, 0] = a * x0 + (1 - a) * x1
    pts[..., 0, 1] = np.broadcast_to(y0, a.shape)
    a = _edge_alpha(z10, z11)                       # right: (x1,y0)-(x1,y1)
    pts[..., 1, 0] = np.broadcast_to(x1, a.shape)
    pts[..., 1, 1] = a * y0 + (1 - a) * y1
    a = _edge_alpha(z01, z11)                       # top: (x0,y1)-(x1,y1)
    pts[..., 2, 0] = a * x0 + (1 - a) * x1
    pts[..., 2, 1] = np.broadcast_to(y1, a.shape)
    a = _edge_alpha(z00, z01)                       # left: (x0,y0)-(x0,y1)
    pts[..., 3, 0] = np.broadcast_to(x0, a.shape)
    pts[..., 3, 1] = a * y0 + (1 - a) * y1

    segs = _SEGS[code]                              # (ny-1, nx-1, 2, 2)
    saddle = (code == 6) | (code == 9)
    if saddle.any():
        center_in = (z00 + z10 + z01 + z11) >= 0
        segs = segs.copy()
        for (c, cin), pairs in _SADDLE.items():
            m = (code == c) & (center_in == cin)
            segs[m] = np.asarray(pairs, dtype=np.int8)

    out: List[np.ndarray] = []
    for k in range(2):                              # up to 2 segments/cell
        ek = segs[..., k, :]                        # (ny-1, nx-1, 2)
        m = ek[..., 0] >= 0
        if not m.any():
            continue
        e = ek[m]                                   # (S_k, 2) edge indices
        p = pts[m]                                  # (S_k, 4, 2)
        idx = np.arange(e.shape[0])
        out.append(np.stack([p[idx, e[:, 0]], p[idx, e[:, 1]]], axis=1))
    if not out:
        return np.zeros((0, 2, 2))
    res = np.concatenate(out, axis=0)
    # the level set passing exactly through a grid node yields degenerate
    # zero-length segments (both crossings collapse onto the node) — drop
    keep = np.linalg.norm(res[:, 0] - res[:, 1], axis=1) > 0
    return res[keep]


def contour_series(xs, ys, f: Callable, level: float = 0.0) -> np.ndarray:
    """Reference-shaped convenience (ContourSeries::new takes x/y iterators
    and ``func_f``): evaluate ``f`` on the meshgrid, return segments of
    ``f(x, y) = level``. ``f`` must accept array arguments (broadcasted
    meshgrid); wrap scalar callables with ``np.vectorize`` if needed."""
    xs = np.asarray(xs, dtype=float)
    ys = np.asarray(ys, dtype=float)
    gx, gy = np.meshgrid(xs, ys)
    return contour_segments(xs, ys, np.asarray(f(gx, gy), dtype=float),
                            level=level)


def chain_segments(segments: np.ndarray, tol: float = 1e-9
                   ) -> List[np.ndarray]:
    """Stitch an (S, 2, 2) segment soup into polylines ((P_i, 2) arrays)
    by joining endpoints closer than ``tol``. Greedy endpoint matching —
    adequate for plotting, not a topology guarantee."""
    segments = np.asarray(segments, dtype=float)
    if segments.size == 0:
        return []

    def key(p):
        return (round(p[0] / tol), round(p[1] / tol))

    def lookup(p):
        """Candidate continuations at ``p``: endpoints within ``tol`` can
        land in any of the 3x3 neighboring quantization buckets (two points
        tol/2 apart may straddle a bucket boundary), so scan all nine and
        keep true matches only."""
        kx, ky = key(p)
        out = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for j, e in ends.get((kx + dx, ky + dy), ()):
                    if not used[j] and \
                            abs(segments[j, e, 0] - p[0]) <= tol and \
                            abs(segments[j, e, 1] - p[1]) <= tol:
                        out.append((j, e))
        return out

    ends = {}
    used = np.zeros(len(segments), dtype=bool)
    for i, seg in enumerate(segments):
        if np.all(np.abs(seg[0] - seg[1]) <= tol):   # degenerate — skip
            used[i] = True
            continue
        for e in range(2):
            ends.setdefault(key(seg[e]), []).append((i, e))
    lines = []
    for i in range(len(segments)):
        if used[i]:
            continue
        used[i] = True
        line = [segments[i, 0], segments[i, 1]]
        for flip in (False, True):
            if flip:
                line.reverse()
            while True:
                cands = lookup(line[-1])
                if not cands:
                    break
                j, e = cands[0]
                used[j] = True
                line.append(segments[j, 1 - e])
        lines.append(np.asarray(line))
    return lines
