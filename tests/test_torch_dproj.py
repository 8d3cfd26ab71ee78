"""DPi, the derivative of the cone projections, in closed form
(``totsu_tpu_torch/solver/dproj.py``) against three oracles on the CPU
in f64:

* central differences (h = 1e-6) of the port's own projection: relative
  1e-6 over the factor, and the adjoint identity <DPi v, w> = <v, DPi^T
  w> to 1e-12;
* autograd (``torch.func.jvp``) of the plain projection, iterations and
  all: relative 1e-6;
* ``jax.jvp`` of the JAX package's projection: relative 1e-6 where that
  derivative itself matches central differences.

Two departures are on purpose and asserted as such:

* a 'jacobi' PSD factor: the JAX package's ``jax.jvp`` through its
  Jacobi sweeps is NaN on most blocks at k <= 16 (ROADMAP §3, "Known
  defects in totsu_tpu"), and autograd through the port's plain sweeps
  is NaN the same way; the closed form is finite and matches central
  differences;
* exp blocks are drawn away from the cone's kinks: blocks whose
  projection lands within 1e-3 |v| of the edge s = 0 (rho = r/s in the
  hundreds and more, where central differences at h = 1e-6 see the
  edge) and blocks whose projection is not optimal (the root finder
  stalls on about 1 block in 10,000 standard-normal ones, in both
  packages: ROADMAP §3) are left out, at most 3% of them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu_torch.solver import cone as tc
from totsu_tpu_torch.solver import dproj
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

H = 1e-6
RTOL = 1e-6
ADJ_RTOL = 1e-12


def _relu3(b):
    return torch.clamp(b, min=0.0)


def _relu3_j(b):
    return jnp.maximum(b, 0.0)


#: (id, JAX factor, port factor)
CASES = [
    ("rpos", jt.rpos(200), tt.rpos(200)),
    ("soc", jt.soc(5, 100), tt.soc(5, 100)),
    ("soc1", jt.soc(1, 50), tt.soc(1, 50)),
    ("rsoc", jt.rsoc(5, 100), tt.rsoc(5, 100)),
    ("exp", jt.expc(500), tt.expc(500)),
    ("pow05", jt.powc(0.5, 500), tt.powc(0.5, 500)),
    ("pow03", jt.powc(0.3, 500), tt.powc(0.3, 500)),
    ("psd_eigh", jt.psd(8, 16, method="eigh"), tt.psd(8, 16, method="eigh")),
    ("psd_ns", jt.psd(6, 4, method="ns"), tt.psd(6, 4, method="ns")),
    ("psd_jacobi", jt.psd(8, 16, method="jacobi"),
     tt.psd(8, 16, method="jacobi")),
    ("custom", jt.custom(3, _relu3_j, 20, grouped=False),
     tt.custom(3, _relu3, 20, grouped=False)),
]
IDS = [c[0] for c in CASES]


def _draw(f, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=f.total), rng.normal(size=f.total), \
        rng.normal(size=f.total)


def _kept(f, seg, dual):
    """The blocks away from the kinks (all but exp keep every block;
    exp: ``chip_smoke.exp_kink_free``, phase 28a's filter)."""
    if f.kind != tc.EXP:
        return np.ones(f.count, bool)
    v = torch.from_numpy((-seg if dual else seg).reshape(-1, 3))
    keep = cs.exp_kink_free(v, tc._proj_exp_blocks(v)).numpy()
    assert keep.mean() >= 0.97
    return keep


def _rel(got, want, f, keep):
    got = got.reshape(f.count, -1)[keep]
    want = want.reshape(f.count, -1)[keep]
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _fd(f, seg, v, dual):
    s, d = torch.from_numpy(seg), torch.from_numpy(v)
    return ((tc._project_factor(f, s + H * d, dual)
             - tc._project_factor(f, s - H * d, dual)) / (2 * H)).numpy()


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "primal"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dpi_matches_central_differences(case, dual):
    _, _, f = case
    seg, v, w = _draw(f, 0)
    keep = _kept(f, seg, dual)
    u, fwd, bwd = dproj.factor_dproj(f, torch.from_numpy(seg), dual)
    assert torch.equal(u, tc._project_factor(f, torch.from_numpy(seg),
                                             dual))
    dv = fwd(torch.from_numpy(v)).numpy()
    assert _rel(dv, _fd(f, seg, v, dual), f, keep) <= RTOL
    # the adjoint identity, over every block
    lhs = float(dv @ w)
    rhs = float(v @ bwd(torch.from_numpy(w)).numpy())
    assert abs(lhs - rhs) <= ADJ_RTOL * max(abs(lhs), 1.0)


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "primal"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dpi_matches_autograd_of_the_plain_projection(case, dual):
    _, _, f = case
    seg, v, _ = _draw(f, 1)
    keep = _kept(f, seg, dual)
    _, ag = torch.func.jvp(lambda z: tc._project_factor(f, z, dual),
                           (torch.from_numpy(seg),), (torch.from_numpy(v),))
    dv = dproj.factor_dproj(f, torch.from_numpy(seg), dual)[1](
        torch.from_numpy(v)).numpy()
    assert np.isfinite(dv).all()
    if f.kind == tc.PSD and f.variant == "jacobi":
        # autograd through the plain Jacobi sweeps: NaN, as in the JAX
        # package; the closed form departs on purpose
        assert not torch.isfinite(ag).all()
        assert _rel(dv, _fd(f, seg, v, dual), f, keep) <= RTOL
        return
    assert _rel(dv, ag.numpy(), f, keep) <= RTOL


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "primal"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dpi_matches_jax_jvp(case, dual):
    _, fj, f = case
    seg, v, _ = _draw(f, 2)
    keep = _kept(f, seg, dual)
    lay_j = jt.ConeLayout([fj])
    _, jv = jax.jvp(lambda z: lay_j.project(z, dual=dual),
                    (jnp.asarray(seg),), (jnp.asarray(v),))
    jv = np.asarray(jv)
    dv = dproj.factor_dproj(f, torch.from_numpy(seg), dual)[1](
        torch.from_numpy(v)).numpy()
    fd = _fd(f, seg, v, dual)
    if f.kind == tc.PSD and f.variant == "jacobi":
        # the JAX package's derivative through its Jacobi sweeps is NaN
        # (ROADMAP §3): the port departs from it on purpose
        nan_blocks = np.isnan(jv.reshape(f.count, -1)).any(axis=1)
        assert nan_blocks.sum() >= f.count // 2
        assert _rel(dv, fd, f, keep) <= RTOL
        return
    # the JAX derivative itself matches central differences here ...
    assert _rel(jv, fd, f, keep) <= RTOL
    # ... and the closed form matches it
    assert _rel(dv, jv, f, keep) <= RTOL


def test_dproj_at_over_c():
    """dproj_at over C = R^n x K* x R+ with every factor kind: u is the
    projection onto C, DPi the block-diagonal of the factors' maps with
    the identity on x and the R+ rule on tau."""
    n = 4
    lay = tt.ConeLayout([tt.zero(3), tt.rpos(5), tt.soc(4, 2), tt.rsoc(3),
                         tt.expc(3), tt.powc(0.4, 2),
                         tt.psd(3, 2, method="jacobi"),
                         tt.custom(2, _relu3, 2, grouped=False)])
    m = lay.dim
    rng = np.random.default_rng(5)
    z = torch.from_numpy(np.concatenate([rng.normal(size=n + m), [0.7]]))
    dp = dproj.dproj_at(lay, n, m, z)

    def proj_c(zz):
        return torch.cat([zz[:n], lay.project(zz[n:n + m], dual=True),
                          torch.clamp(zz[-1:], min=0.0)])

    assert torch.equal(dp.u, proj_c(z))
    v = torch.from_numpy(rng.normal(size=n + m + 1))
    w = torch.from_numpy(rng.normal(size=n + m + 1))
    fd = (proj_c(z + H * v) - proj_c(z - H * v)) / (2 * H)
    got = dp.apply(v)
    assert float((got - fd).norm() / fd.norm()) <= RTOL
    assert abs(float(got @ w) - float(v @ dp.apply_t(w))) <= \
        ADJ_RTOL * abs(float(got @ w))
    with pytest.raises(ValueError, match="cone of dim"):
        dproj.dproj_at(lay, n, m + 1, z)


def test_exp_edge_and_trivial_cases():
    """The exp Jacobian's own cases: in the cone I, in the polar 0, in the
    negative quadrant diag(1, 0, step(t0)), a root on the edge s = 0
    diag(0, 0, step(t0))."""
    v = torch.tensor([[0.0, 1.0, 2.0],        # in K (e^0 = 1 <= 2)
                      [1.0, -1.0, -2.0],      # in the polar
                      [-1.0, -2.0, 3.0],      # negative quadrant, t0 > 0
                      [-1.0, -2.0, -3.0],     # negative quadrant, t0 < 0
                      [0.5, -2.0, 1.0]],      # root on the edge
                     dtype=torch.float64)
    p = tc._proj_exp_blocks(v)
    p[4] = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    jac = dproj.exp_jacobian(v, p)
    eye = torch.eye(3, dtype=torch.float64)
    assert torch.equal(jac[0], eye)
    assert torch.equal(jac[1], torch.zeros(3, 3, dtype=torch.float64))
    assert torch.equal(jac[2], torch.diag(torch.tensor(
        [1.0, 0.0, 1.0], dtype=torch.float64)))
    assert torch.equal(jac[3], torch.diag(torch.tensor(
        [1.0, 0.0, 0.0], dtype=torch.float64)))
    assert torch.equal(jac[4], torch.diag(torch.tensor(
        [0.0, 0.0, 1.0], dtype=torch.float64)))
