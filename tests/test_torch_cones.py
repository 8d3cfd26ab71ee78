"""Cone projections of the PyTorch port against the JAX package.

Every input is made once with numpy from a fixed seed and handed to both
``totsu_tpu.solver.cone`` and ``totsu_tpu_torch.solver.cone``. The zero,
R+, SOC and RSOC projections run in f64; they are the same closed forms,
so they agree to roundoff (atol 1e-12). The exp and pow projections run
in f64 and f32 at adversarial scales, against JAX and against their
Moreau certificates (tolerances stated at each test).
"""

import numpy as np
import jax
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


def test_cone_from_reference_round_trip():
    jl = jcone.ConeLayout([jcone.soc(3, 2), jcone.rsoc(4), jcone.rpos(2),
                           jcone.zero(1), jcone.psd(3, method="eigh"),
                           jcone.powc(0.25, 2)])
    tl = interop.cone_from_reference(jl)
    assert tl.dim == jl.dim
    assert [(f.kind, f.dim, f.count, f.variant, f.alpha)
            for f in tl.factors] == [(f.kind, f.dim, f.count, f.variant,
                                      f.alpha) for f in jl.factors]


# ---------------------------------------------------------------------------
# exponential and power cones: the fixed-trip Newton-bisection cores

EXP_POW_LAYOUTS = {
    "expc64": [("expc", (64,))],
    "powc0.1": [("powc", (0.1, 16))],
    "powc0.3": [("powc", (0.3, 16))],
    "powc0.5": [("powc", (0.5, 16))],
    "powc0.9": [("powc", (0.9, 16))],
    "exp_pow_mix": [("soc", (3, 2)), ("expc", (4,)), ("rsoc", (4, 2)),
                    ("powc", (0.3, 3)), ("rpos", (5,)), ("zero", (3,)),
                    ("powc", (0.9, 2)), ("rsoc", (1,))],
}
# tolerance on |port - JAX| relative to the row's max-abs: the same
# arithmetic in the same order, so they agree to a few ulps (measured on
# these inputs: 3e-16 in f64, 1.1e-7 in f32); the margin covers the two
# libms' exp and log differing in the last bit, which the root finders
# can amplify (near the pow root's |z0| endpoint an ulp of r moves y by
# up to sqrt(ulp))
EXP_POW_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _exp_pow_layouts(name):
    spec = EXP_POW_LAYOUTS[name]
    return (jcone.ConeLayout([getattr(jcone, k)(*a) for k, a in spec]),
            tcone.ConeLayout([getattr(tcone, k)(*a) for k, a in spec]))


def _adversarial_rows(dim, seed):
    """Rows at the scales of tests/test_cones.py's exp/pow tests (normal
    at 3, 50 and 1e-3, scaled by 1e-6 to 1e6), the hand-picked
    ill-conditioned blocks, and blocks in the cone, in the polar, in the
    negative quadrant and on the boundary."""
    rng = np.random.default_rng(seed)
    special = np.array([
        [1e-8, -5.0, 3.0], [1e-3, -100.0, 7.0], [-8.16, 0.181, -2.86],
        [0.0066, -2.37, 0.426], [0.0, -1.0, 1.0], [0.0, 0.0, 0.0],
        [1e3, 1.0, -1.0], [-1e3, 2.0, 2.0], [1.0, 1e3, 1.0],
        [1.0, 1.0, 0.0], [-1.0, -1.0, 5.0], [0.0, -1.0, 2.0],
        [1e8, -1.0, 3.0], [-5.0, 1e-9, 1e-9], [0.0, 1.0, 2.0],
        [1.0, -9.0, -1.0], [-1.0, -2.0, 5.0], [-1.0, -2.0, -5.0],
        [4.0, 1.0, 2.0], [-1.0, -1.0, 0.5], [-3.0, 7.0, 0.0],
        [1.0, 1.0, 1.0], [0.0, 1.0, 1.0], [1.0, 0.0, 1.0]])
    rows = [np.resize(special.ravel(), dim)]
    for scale in (3.0, 50.0, 1e-3):
        for mult in (1e-6, 1.0, 1e6):
            rows.append(rng.normal(scale=scale, size=dim) * mult)
    return np.stack(rows)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
@pytest.mark.parametrize("name", list(EXP_POW_LAYOUTS))
def test_exp_pow_projection_matches_jax(name, dual, dtype):
    jl, tl = _exp_pow_layouts(name)
    x = _adversarial_rows(jl.dim, list(EXP_POW_LAYOUTS).index(name))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = np.asarray(jax.jit(jax.vmap(lambda r: jl.project(r, dual=dual)))(
        jnp.asarray(x, jdt)))
    got = np.stack([tl.project(torch.tensor(r, dtype=dtype), dual=dual)
                    .numpy() for r in x.astype(want.dtype)])
    assert got.dtype == want.dtype
    scale = np.abs(x).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= EXP_POW_RTOL[dtype] * scale).all()


def _in_exp(p, tol):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    with np.errstate(over="ignore"):
        smooth = (y > 0) & (
            y * np.exp(np.clip(x / np.where(y != 0, y, 1.0), -700, 700))
            <= z + tol)
    ray = (np.abs(y) <= tol) & (x <= tol) & (z >= -tol)
    return smooth | ray


def _in_exp_polar(p, tol):
    u, v, w = p[..., 0], p[..., 1], p[..., 2]
    with np.errstate(over="ignore"):
        smooth = (u > 0) & (
            u * np.exp(np.clip(v / np.where(u != 0, u, 1.0), -700, 700))
            <= -np.e * w + tol)
    ray = (u <= tol) & (v <= tol) & (w <= tol)
    return smooth | ray


def _pow_val(x, y, a):
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.exp(a * np.log(np.maximum(x, 1e-300))
                   + (1 - a) * np.log(np.maximum(y, 1e-300)))
    return np.where((x > 0) & (y > 0), v, 0.0)


def _in_powc(p, a, tol):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return (x >= -tol) & (y >= -tol) & (_pow_val(x, y, a)
                                        >= np.abs(z) - tol)


def _exp_blocks(v, dtype):
    return tcone._proj_exp_blocks(torch.tensor(v, dtype=dtype)).double() \
        .numpy()


def test_exp_projection_moreau_certificate():
    # port-only mirror of test_exp_projection_moreau_optimality: vp in K,
    # v - vp in the polar and <vp, v - vp> = 0 certify the projection
    # (Moreau), f64 to 1e-7 and f32 to 2e-3 relative; idempotent in f64
    rng = np.random.default_rng(11)
    v = np.concatenate([
        rng.normal(scale=3.0, size=(3000, 3)),
        rng.normal(scale=50.0, size=(500, 3)),
        rng.normal(scale=1e-3, size=(500, 3)),
        [[1e-8, -5.0, 3.0], [1e-3, -100.0, 7.0], [-8.16, 0.181, -2.86],
         [0.0066, -2.37, 0.426], [0.0, -1.0, 1.0], [0.0, 0.0, 0.0],
         [1e3, 1.0, -1.0], [-1e3, 2.0, 2.0], [1.0, 1e3, 1.0]]])
    scale = 1.0 + np.linalg.norm(v, axis=1)
    for dtype, tol in ((torch.float64, 1e-7), (torch.float32, 2e-3)):
        vp = _exp_blocks(v, dtype)
        vd = v - vp
        assert _in_exp(vp, tol * scale).all()
        assert _in_exp_polar(vd, tol * scale).all()
        assert (np.abs((vp * vd).sum(1)) <= tol * scale ** 2).all()
    vp = _exp_blocks(v, torch.float64)
    np.testing.assert_allclose(_exp_blocks(vp, torch.float64), vp,
                               atol=1e-10)


def test_exp_dual_moreau_certificate():
    # the dual projection lies in K* = -polar, its residual in -K
    lay = tcone.ConeLayout([tcone.expc(64)])
    v = np.random.default_rng(3).normal(scale=2.0, size=64 * 3)
    out = lay.project(torch.from_numpy(v), dual=True).numpy().reshape(64, 3)
    vd = v.reshape(64, 3) - out
    scale = 1.0 + np.linalg.norm(v.reshape(64, 3), axis=1)
    assert _in_exp_polar(-out, 1e-7 * scale).all()
    assert _in_exp(-vd, 1e-7 * scale).all()
    assert (np.abs((out * vd).sum(1)) <= 1e-6 * scale ** 2).all()


@pytest.mark.parametrize("alpha", [0.1, 0.3, 0.5, 0.9])
def test_pow_projection_certificates(alpha):
    # port-only mirror of test_pow_projection_certificates: vp in K,
    # <vp, v - vp> = 0 and the variational inequality <v - vp, q - vp> <= 0
    # over sampled q in K; membership is skipped on blocks pinned to the
    # x = 0 / y = 0 edge, where the log of x^a y^(1-a) diverges
    rng = np.random.default_rng(5)
    v = np.concatenate([
        rng.normal(scale=3.0, size=(500, 3)),
        rng.normal(scale=80.0, size=(100, 3)),
        rng.normal(scale=1e-4, size=(100, 3)),
        [[0, 0, 0], [1, 1, 0], [-1, -1, 5], [0, -1, 2], [1e8, -1, 3],
         [-5, 1e-9, 1e-9]]])
    scale = 1.0 + np.linalg.norm(v, axis=1)
    qxy = np.abs(rng.normal(size=(100, 2))) + 1e-6
    qz = _pow_val(qxy[:, 0], qxy[:, 1], alpha) * np.tanh(
        rng.normal(size=100))
    q = np.concatenate([qxy, qz[:, None]], axis=1)
    qs = 1.0 + np.linalg.norm(q, axis=1)
    for dtype, tol, mtol in ((torch.float64, 1e-8, 1e-6),
                             (torch.float32, 2e-3, 5e-3)):
        vp = tcone._proj_pow_blocks(torch.tensor(v, dtype=dtype),
                                    alpha).double().numpy()
        vd = v - vp
        edge = np.minimum(vp[:, 0], vp[:, 1]) < 1e-6 * scale
        assert (_in_powc(vp, alpha, mtol * scale) | edge).all()
        assert (np.abs((vp * vd).sum(1)) <= tol * scale ** 2).all()
        vi = vd @ q.T - (vd * vp).sum(1)[:, None]
        assert (vi <= tol * scale[:, None] * qs[None, :]).all()
    vp = tcone._proj_pow_blocks(torch.from_numpy(v), alpha)
    np.testing.assert_allclose(tcone._proj_pow_blocks(vp, alpha).numpy(),
                               vp.numpy(), atol=1e-6)


def test_pow_per_block_alpha_matches_scalar():
    # a per-block exponent tensor gives each block its own factor's result
    rng = np.random.default_rng(8)
    v = torch.from_numpy(rng.normal(scale=2.0, size=(40, 3)))
    alphas = np.repeat([0.1, 0.3, 0.5, 0.9], 10)
    got = tcone._proj_pow_blocks(v, torch.from_numpy(alphas))
    for k, a in enumerate((0.1, 0.3, 0.5, 0.9)):
        rows = slice(10 * k, 10 * k + 10)
        torch.testing.assert_close(got[rows],
                                   tcone._proj_pow_blocks(v[rows], a),
                                   rtol=0, atol=0)


def test_exp_pow_trip_counts_match_jax():
    # the fixed trip counts per dtype are the JAX package's
    assert tcone.EXP_EXPAND_TRIPS == 40
    assert tcone.EXP_TRIPS == {torch.float32: 26, torch.float64: 38}
    assert tcone.POW_TRIPS == {torch.float32: 28, torch.float64: 54}
