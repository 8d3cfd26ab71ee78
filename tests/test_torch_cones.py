"""Cone projections of the PyTorch port against the JAX package.

Every input is made once with numpy from a fixed seed and handed to both
``totsu_tpu.solver.cone`` and ``totsu_tpu_torch.solver.cone``. Both run in
f64; the projections are the same closed forms, so they agree to
roundoff (atol 1e-12).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from totsu_tpu.solver import cone as jcone
from totsu_tpu_torch.solver import cone as tcone
from totsu_tpu_torch import interop

ATOL = 1e-12

# (factor function name, args) pairs, built the same way in both packages
LAYOUTS = {
    "zero": [("zero", (7,))],
    "rpos": [("rpos", (9,))],
    "soc": [("soc", (4, 5))],
    "soc_dim1": [("soc", (1, 3))],
    "rsoc": [("rsoc", (5, 4))],
    "rsoc_dim2": [("rsoc", (2, 3))],
    "rsoc_dim1": [("rsoc", (1, 3))],
    "mixed": [("soc", (3, 2)), ("rsoc", (4, 2)), ("rpos", (5,)),
              ("soc", (1,)), ("zero", (3,)), ("rsoc", (1, 2))],
}


def _layouts(name):
    spec = LAYOUTS[name]
    return (jcone.ConeLayout([getattr(jcone, k)(*a) for k, a in spec]),
            tcone.ConeLayout([getattr(tcone, k)(*a) for k, a in spec]))


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_projection_matches_jax(name, dual):
    jl, tl = _layouts(name)
    rng = np.random.default_rng(sorted(LAYOUTS).index(name))
    # scaled so that every SOC case (interior, polar, boundary) occurs
    x = rng.normal(size=(6, jl.dim)) * rng.choice([0.1, 1.0, 10.0],
                                                   size=(6, 1))
    for row in x:
        want = np.asarray(jl.project(jnp.asarray(row), dual=dual))
        got = tl.project(torch.from_numpy(row), dual=dual).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_group_min_matches_jax(name):
    jl, tl = _layouts(name)
    t = np.random.default_rng(3).random(jl.dim)
    want = np.asarray(jl.group_min(jnp.asarray(t)))
    got = tl.group_min(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)


def test_soc_cases_by_construction():
    # interior point unchanged, polar point to 0, outside point to the
    # boundary (||v|| == s after projection)
    lay = tcone.ConeLayout([tcone.soc(3, 3)])
    x = torch.tensor([2.0, 1.0, 1.0, -2.0, 1.0, 1.0, 0.5, 3.0, 4.0],
                     dtype=torch.float64)
    p = lay.project(x, dual=False).reshape(3, 3)
    np.testing.assert_allclose(p[0].numpy(), [2.0, 1.0, 1.0])
    np.testing.assert_allclose(p[1].numpy(), [0.0, 0.0, 0.0])
    np.testing.assert_allclose(float(p[2, 0]),
                               float(torch.linalg.vector_norm(p[2, 1:])),
                               rtol=1e-14)


@pytest.mark.parametrize("kind,args", [("psd", (2,)), ("expc", (1,)),
                                       ("powc", (0.3,))])
def test_unported_projections_raise(kind, args):
    lay = tcone.ConeLayout([getattr(tcone, kind)(*args)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lay.project(torch.zeros(lay.dim, dtype=torch.float64), dual=False)


def test_cone_from_reference_round_trip():
    jl = jcone.ConeLayout([jcone.soc(3, 2), jcone.rsoc(4), jcone.rpos(2),
                           jcone.zero(1), jcone.psd(3, method="eigh"),
                           jcone.powc(0.25, 2)])
    tl = interop.cone_from_reference(jl)
    assert tl.dim == jl.dim
    assert [(f.kind, f.dim, f.count, f.variant, f.alpha)
            for f in tl.factors] == [(f.kind, f.dim, f.count, f.variant,
                                      f.alpha) for f in jl.factors]
