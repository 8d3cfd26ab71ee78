"""pdhg against the direct engine on random feasible bounded instances over
every cone type, in the PyTorch port against the JAX package: the twin
of ``tests/test_cross_engine.py``.

Each instance (b = A x0 + s0 with s0 strictly inside K, box rows on every
variable) is made once with numpy and solved by both engines in both
packages in f64. Per engine the port must give the JAX package's status
and iteration count exactly and its objective to 1e-9 relative; the two
engines must agree with each other as in the JAX test (objectives within
5e-5 (1 + |o1| + |o2|), each solution primal feasible to 1e-5 (1 +
||b||) by the f64 projection). The exp and mixed cases are in
``test_torch_cross_engine_exp.py``: the port's pdhg host loop projects
exp/pow blocks with the plain root finders on the CPU, about 5 ms an
iteration, and one of those instances takes 13,700 iterations.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu_torch import interop
from totsu_tpu_torch.ops import sympack
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


def _interior(kind, dim):
    """A strictly interior point of one block of a factor."""
    if kind == "rpos":
        return np.ones(dim)
    if kind == "zero":
        return np.zeros(dim)
    if kind == "soc":
        p = np.full(dim, 0.3)
        p[0] = 2.0
        return p
    if kind == "rsoc":
        p = np.full(dim, 0.3)
        p[0] = p[1] = 2.0
        return p
    if kind == "exp":
        return np.array([0.0, 1.0, 2.0])     # 1 e^0 = 1 < 2
    if kind == "pow":
        return np.array([2.0, 2.0, 1.0])     # 2^a 2^(1-a) = 2 > 1
    if kind == "psd":
        k = sympack.order_from_len(dim)
        return sympack.pack(2.0 * torch.eye(k, dtype=torch.float64),
                            scaled=True).numpy()
    raise AssertionError(kind)


def _instance(factors, n, seed):
    rng = np.random.default_rng(seed)
    lay_j = jt.ConeLayout(list(factors) + [jt.rpos(2 * n)])
    m = lay_j.dim
    a = np.concatenate([rng.normal(size=(m - 2 * n, n)) / np.sqrt(n),
                        np.eye(n), -np.eye(n)])
    s0 = np.concatenate([np.tile(_interior(f.kind, f.dim), f.count)
                         for f in factors] + [np.ones(2 * n)])
    x0 = rng.normal(size=n) * 0.5
    b = a @ x0 + s0
    c = rng.normal(size=n)
    return c, a, b, lay_j


CASES = [
    ("lp", [jt.rpos(6)]),
    ("eq+lp", [jt.zero(2), jt.rpos(5)]),
    ("soc", [jt.soc(4, count=2), jt.rpos(3)]),
    ("rsoc", [jt.rsoc(5), jt.zero(1)]),
    ("pow", [jt.powc(0.3, count=2), jt.rpos(2)]),
    ("psd", [jt.psd(3), jt.rpos(2)]),
]


def check_case(factors, seed):
    """Both engines of both packages on one instance."""
    n = 5
    c, a, b, lay_j = _instance(factors, n, seed)
    lay = interop.cone_from_reference(lay_j)
    data = interop.problem_from_numpy(c, a, b, device="cpu")
    objs = []
    for method in ("pdhg", "direct"):
        pj = jt.SolverParam(max_iter=400_000, eps_acc=1e-7, check_period=20,
                            method=method)
        rj = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                          lay_j, pj)
        rt = tt.solve_jit(*data, lay, interop.param_from_reference(pj))
        assert rt.status == int(rj.status) == tt.SolverStatus.CONVERGED, \
            method
        assert rt.iters == int(rj.iters), method
        x = rt.x.numpy()
        o_j = float(c @ np.asarray(rj.x))
        objs.append(float(c @ x))
        assert abs(objs[-1] - o_j) <= 1e-9 * (1.0 + abs(o_j)), method
        s = b - a @ x
        proj = lay.project(torch.from_numpy(s), dual=False).numpy()
        assert np.linalg.norm(s - proj) <= 1e-5 * (1 + np.linalg.norm(b))
    o1, o2 = objs
    assert abs(o1 - o2) <= 5e-5 * (1.0 + abs(o1) + abs(o2)), (o1, o2)


@pytest.mark.parametrize("name,factors", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pdhg_vs_direct_agree(name, factors, seed):
    check_case(factors, seed)
