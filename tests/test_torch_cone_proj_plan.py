"""The blocked exp/pow projection's launch plan and lane-parallel root
finder (``ops/kernels/cone_proj.py`` ``plan`` and ``_lane_model``).

The plan is a pure function of the block count, kind, dtype and the
card's SM count, so its guarantees are checked here: every block in
exactly one warp, whole warps, no empty CTA, the SMs covered when there
are warps enough. The kernel runs only on the card
(``chip_smoke.py``); its root finder has a torch model (the same points,
the same lowest-lane ballot rule, the same Newton step), held here
against the plain version and the JAX package's ``_proj_exp_blocks`` /
``_proj_pow_blocks`` on the smoke's five kinds of block (random, in the
cone, in the polar, in the negative quadrant, on the boundary) at scales
1e-6..1e6, within phase 2b's tolerances of the block's norm: 2e-5 (f32),
2e-10 (f64). The projections agree to the root's last bits, not bit for
bit: the model stops at another point of the same ulp-wide bracket
(largest measured here: 1.7e-7 in f32, 4.9e-13 in f64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from totsu_tpu.solver import cone as jcone
from totsu_tpu_torch.ops.kernels import cone_proj as cp

TOL = {torch.float32: 2e-5, torch.float64: 2e-10}
COUNTS = (0, 1, 7, 50, 600, 2000, 5000, 100_000)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("count", COUNTS)
def test_plan_covers_every_block_once(count, sms, dtype, monkeypatch):
    # pure: no device is asked, and a second call gives the same plan
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: pytest.fail("plan asked the device"))
    pl = cp.plan(count, "exp", dtype, sms)
    assert pl == cp.plan(count, "exp", dtype, sms)
    assert pl.count == count and cp.LANES == 32
    assert pl.threads in cp.CTA_THREADS and pl.threads % 32 == 0
    total = count * cp.LANES
    # every block has a warp, and no CTA is past the last warp
    assert pl.grid * pl.threads >= total
    assert pl.grid == 0 if count == 0 else (pl.grid - 1) * pl.threads < total
    if count <= 5000:  # each block exactly once: warp = thread // 32
        warps = np.arange(pl.grid * pl.threads) // cp.LANES
        hits = np.bincount(warps[warps < count], minlength=count)
        assert (hits == cp.LANES).all()
    # the SMs covered when there are warps enough, in the largest CTA that
    # covers them and holds no more threads than there are
    assert pl.grid >= min(sms, count)
    bigger = [t for t in cp.CTA_THREADS if t > pl.threads]
    assert all(t > total or -(-total // t) < min(sms, count) for t in bigger)


def test_plan_for_the_main_path():
    # the logistic regression's 2000 exp blocks on an H100: a warp per
    # block, 2000 warps resident at once over 132 SMs
    pl = cp.plan(2000, "exp", torch.float32, 132)
    assert (pl.threads, pl.grid) == (256, 250)
    assert pl.describe() == "2000 blocks, a warp per block, 250 CTAs x " \
        "256 threads"
    # the GP's host loop (600 blocks) and a single block
    assert (cp.plan(600, "exp", torch.float32, 132).grid,
            cp.plan(600, "exp", torch.float32, 132).threads) == (150, 128)
    assert cp.plan(1, "pow", torch.float64, 132) == cp.Plan(1, 32, 1)


def test_plan_checks_its_arguments():
    with pytest.raises(ValueError, match="kind"):
        cp.plan(10, "soc", torch.float32, 132)
    with pytest.raises(ValueError, match="dtype"):
        cp.plan(10, "exp", torch.float16, 132)
    with pytest.raises(ValueError, match="sm_count"):
        cp.plan(10, "exp", torch.float32, 0)


def test_device_plan_reads_the_sm_count(monkeypatch):
    class Props:
        multi_processor_count = 16
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    assert cp.device_plan(600, "pow", torch.float64, "cuda") \
        == cp.plan(600, "pow", torch.float64, 16)


def _inputs(kind, alpha, dtype):
    rng = np.random.default_rng(7 + int(10 * alpha))
    blocks = cs.cone_blocks(kind, 500, rng, alpha)
    return torch.tensor(blocks, dtype=dtype)


def _jax(xb, kind, alpha, dual):
    jdt = jnp.float32 if xb.dtype == torch.float32 else jnp.float64
    x = jnp.asarray(xb.numpy(), jdt)
    if kind == "exp":
        def proj(v):
            return jcone._proj_exp_blocks(v)
    else:
        def proj(v):
            return jcone._proj_pow_blocks(v, alpha)
    return torch.from_numpy(np.array(x + proj(-x) if dual else proj(x)))


def _rel_err(got, want, xb):
    nrm = torch.linalg.vector_norm(xb.double(), dim=1).clamp(min=1e-300)
    return float(((got - want).double().abs().amax(1) / nrm).max())


KINDS = [("exp", 0.5), ("pow", 0.1), ("pow", 0.3), ("pow", 0.5),
         ("pow", 0.9)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
@pytest.mark.parametrize("kind,alpha", KINDS,
                         ids=["exp", "pow0.1", "pow0.3", "pow0.5", "pow0.9"])
def test_lane_model_matches_plain_and_jax(kind, alpha, dual, dtype):
    xb = _inputs(kind, alpha, dtype)
    want = cp.cone_proj_plain(xb, kind, alpha, dual)
    ref = _jax(xb, kind, alpha, dual)
    assert _rel_err(want, ref, xb) <= TOL[dtype]
    got, chains = cp._lane_model(xb, kind, alpha, dual)
    assert got.dtype == dtype and got.shape == xb.shape
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want, xb) <= TOL[dtype]
    assert _rel_err(got, ref, xb) <= TOL[dtype]
    # the trivial fifths need no root: in the cone, in the polar
    assert chains.numel() < xb.shape[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["exp", "pow"])
def test_lane_model_chain_stays_under_the_stated_bound(kind, dtype):
    # phase 2b's inputs (2000 blocks; pow at four exponents per block),
    # primal and dual: the longest chain of dependent evaluations at L =
    # 32 stays under the kernel's stated bound, far below the serial root
    # finder's trips on the same blocks
    rng = np.random.default_rng(1)
    exp_np = cs.cone_blocks("exp", 2000, rng)
    pow_np = np.concatenate([cs.cone_blocks("pow", 500, rng, al)
                             for al in (0.1, 0.3, 0.5, 0.9)])
    xb = torch.tensor(exp_np if kind == "exp" else pow_np, dtype=dtype)
    al = (torch.tensor(np.repeat([0.1, 0.3, 0.5, 0.9], 500), dtype=dtype)
          if kind == "pow" else 0.0)
    for dual in (False, True):
        _, chains = cp._lane_model(xb, kind, al, dual)
        serial = cs.cone_proj_trips(xb, kind, al, dual)[1]
        assert int(chains.max()) <= cp.CHAIN_BOUND[dtype]
        assert 2 * int(chains.max()) <= serial


def test_lane_model_with_one_lane_is_the_serial_pow_finder():
    # one lane has no multisection points: the trips are the serial
    # hybrid's, bit for bit (pow has no expansion)
    xb = _inputs("pow", 0.3, torch.float64)
    for dual in (False, True):
        got, chains = cp._lane_model(xb, "pow", 0.3, dual, lanes=1)
        torch.testing.assert_close(got, cp.cone_proj_plain(xb, "pow", 0.3,
                                                           dual),
                                   rtol=0, atol=0)
        assert int(chains.sum()) == sum(
            cs.cone_proj_trips(xb, "pow", 0.3, dual)[0])


def test_lane_model_per_block_alpha():
    xb = torch.cat([_inputs("pow", a, torch.float64)[:40]
                    for a in (0.1, 0.3, 0.5, 0.9)])
    alphas = torch.tensor(np.repeat([0.1, 0.3, 0.5, 0.9], 40))
    got = cp._lane_model(xb, "pow", alphas, True)[0]
    for k, a in enumerate((0.1, 0.3, 0.5, 0.9)):
        rows = slice(40 * k, 40 * k + 40)
        torch.testing.assert_close(
            got[rows], cp._lane_model(xb[rows], "pow", a, True)[0], rtol=0,
            atol=0)


def test_sect_points_in_bits_are_ordered_and_inside():
    # pow's multisection points, evenly in the bit pattern: inside the
    # bracket, ordered, spread over its binades (geometric toward 0)
    for dt in (torch.float32, torch.float64):
        lo = torch.tensor([0.0, 1e-30, 0.25], dtype=dt)
        hi = torch.tensor([0.5, 1.0, 0.25], dtype=dt)
        pts = cp._sect_points(lo, hi, 32, True)
        assert pts.shape == (3, 31)
        assert bool((pts >= lo[:, None]).all() and (pts <= hi[:, None]).all())
        assert bool((pts[:, 1:] >= pts[:, :-1]).all())
        assert float(pts[0, 0]) < 1e-30  # 0 to 0.5: the first is tiny
        assert bool((pts[2] == 0.25).all())
        vals = cp._sect_points(lo, hi, 32, False)
        torch.testing.assert_close(vals[0, 15], torch.tensor(0.25, dtype=dt))
