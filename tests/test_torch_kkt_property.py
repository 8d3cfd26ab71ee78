"""Conic programs with constructed optima in the PyTorch port against the
JAX package: the twin of ``tests/test_kkt_property.py``.

Each instance is built from a KKT point first (s* in K, y* in K*,
<s*, y*> = 0; b = A x* + s*, c = -A' y*), once with numpy, and solved by
both packages on the pdhg engine and on the direct engine in f64. The
port must give the JAX package's status and iteration count exactly and
its x to 1e-8, and meet the JAX test's own contract (objective within
1e-4 of c'x*, primal feasibility within 1e-3 (1 + ||b||)).
"""

import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.ops import sympack
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


def complementary_pair(kind, dim, rng):
    """Random (s, y) with s in K, y in K*, <s, y> = 0 for one block (the
    JAX test's draws, in its order)."""
    if kind == "zero":
        return np.zeros(dim), rng.normal(size=dim)
    if kind == "rpos":
        s = np.maximum(rng.normal(size=dim), 0.0)
        y = np.where(s > 0, 0.0, np.abs(rng.normal(size=dim)))
        return s, y
    if kind == "soc":
        case = rng.integers(3)
        if case == 0:          # s interior, y = 0
            v = rng.normal(size=dim - 1)
            s = np.concatenate([[np.linalg.norm(v) + 1.0], v])
            return s, np.zeros(dim)
        if case == 1:          # s = 0, y interior
            v = rng.normal(size=dim - 1)
            y = np.concatenate([[np.linalg.norm(v) + 1.0], v])
            return np.zeros(dim), y
        v = rng.normal(size=dim - 1)          # boundary pair
        nv = np.linalg.norm(v)
        t = abs(rng.normal()) + 0.5
        return (np.concatenate([[nv], v]),
                t * np.concatenate([[nv], -v]))
    if kind == "psd":
        k = sympack.order_from_len(dim)
        q, _ = np.linalg.qr(rng.normal(size=(k, k)))
        npos = rng.integers(0, k + 1)
        wpos = np.zeros(k)
        wneg = np.zeros(k)
        wpos[:npos] = np.abs(rng.normal(size=npos)) + 0.1
        wneg[npos:] = np.abs(rng.normal(size=k - npos)) + 0.1

        def pack(mat):
            return sympack.pack(torch.from_numpy(mat), scaled=True).numpy()

        return pack((q * wpos) @ q.T), pack((q * wneg) @ q.T)
    raise ValueError(kind)


def build_problem(factors, n, rng):
    m = sum(d for _, d in factors)
    a = rng.normal(size=(m, n))
    x_star = rng.normal(size=n)
    s_parts, y_parts = [], []
    for kind, dim in factors:
        s, y = complementary_pair(kind, dim, rng)
        s_parts.append(s)
        y_parts.append(y)
    b = a @ x_star + np.concatenate(s_parts)
    c = -a.T @ np.concatenate(y_parts)

    def mk(kind, d):
        if kind == "psd":
            return jt.psd(sympack.order_from_len(d))
        return getattr(jt, kind)(d)

    layout = jt.ConeLayout([mk(k, d) for k, d in factors])
    return c, a, b, layout, float(c @ x_star)


CASES = [
    [("rpos", 8)],
    [("rpos", 5), ("zero", 3)],
    [("soc", 4)],
    [("soc", 3), ("rpos", 4), ("zero", 2)],
    [("soc", 5), ("soc", 3)],
    [("psd", 6)],
    [("psd", 10), ("rpos", 3)],
]


@pytest.mark.parametrize("factors", CASES)
@pytest.mark.parametrize("method", ["pdhg", "direct"])
def test_constructed_optimum(factors, method):
    rng = np.random.default_rng(zlib.crc32(str(factors).encode()))
    c, a, b, lay_j, obj_star = build_problem(factors, 6, rng)
    pj = jt.SolverParam(max_iter=300_000, method=method)
    rj = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay_j,
                      pj)
    lay = interop.cone_from_reference(lay_j)
    rt = tt.solve_jit(*interop.problem_from_numpy(c, a, b, device="cpu"),
                      lay, interop.param_from_reference(pj))
    assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED
    assert rt.iters == int(rj.iters)
    x = rt.x.numpy()
    np.testing.assert_allclose(x, np.asarray(rj.x), rtol=0, atol=1e-8)
    assert abs(float(c @ x) - obj_star) / (1.0 + abs(obj_star)) < 1e-4
    slack = b - a @ x
    proj = lay.project(torch.from_numpy(slack), dual=False).numpy()
    assert np.linalg.norm(slack - proj) < 1e-3 * (1 + np.linalg.norm(b))
