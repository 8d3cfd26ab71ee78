"""The SDP, SOCP and QCQP reductions of the port against the JAX package.

``sdp``/``socp``/``qcqp`` in both packages take the same numpy inputs;
the conic data must be the same (f64, to roundoff: the P^1/2 of the QCQP
come from two eigh). The solves run in f64 through both packages' engines
and must match in status and iteration count, with x and y within 1e-8.
The instances are the reference's analytic tests (tests/test_problems.py),
a small partitioning SDP (k = 8: dense as in examples/partitioning_sdp.py,
and structured as in benchmarks/benchmark_sdp.py with each PSD method) and
a nearest-correlation instance (k = 4, examples/nearestcorr_batch_sdp.py),
built by ``chip_smoke.py``'s numpy copies of those builders (held to the
examples' own in tests/test_torch_chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.problems import qcqp as jqcqp, sdp as jsdp, socp as jsocp
from totsu_tpu.solver.operator import (DenseOp as JDenseOp,
                                       DiagOp as JDiagOp,
                                       VStackOp as JVStackOp)

PARAM = dict(max_iter=100_000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the problems are small, and the suite runs
    several workers on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(layout):
    return [(f.kind, f.dim, f.count, f.variant) for f in layout.factors]


def _same_data(pt, pj, rtol=0.0):
    assert _spec(pt.cone) == _spec(pj.cone)
    for got, want in ((pt.c, pj.c), (pt.a.a, pj.a.a), (pt.b, pj.b)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=1e-14 if rtol else 0.0)


def _same_solve(rt, rj):
    assert rt.status == int(rj.status)
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), rtol=0,
                               atol=1e-8)


SDP1 = dict(c=[1.0, 1.0], f_mats=np.stack([np.diag([-1.0, 0.0]),
                                           np.diag([0.0, -1.0]),
                                           np.diag([3.0, 4.0])]))


@pytest.mark.parametrize("profile", ["reference", "fast"])
def test_sdp1(profile):
    # ref totsu/tests/sdp.rs test_sdp1: diag LMI -> (3, 4); 'auto' resolves
    # to eigh (reference) or stays exact at eps_acc 1e-6 (fast)
    pj = jsdp(**SDP1)
    pt = tt.problems.sdp(**SDP1, device="cpu")
    _same_data(pt, pj)
    kw = dict(PARAM, profile=profile)
    rj = pj.solve(jt.SolverParam(**kw))
    rt = pt.solve(tt.SolverParam(**kw))
    _same_solve(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), [3.0, 4.0], atol=1e-3)


def test_sdp_class_wrapper_matbuild():
    def build(mod):
        mb = mod.MatBuild
        syms_f = [mb.sympack(2).set_iter_rowmaj([-1.0, 0.0, 0.0, 0.0]),
                  mb.sympack(2).set_iter_rowmaj([0.0, 0.0, 0.0, -1.0]),
                  mb.sympack(2).set_iter_rowmaj([3.0, 0.0, 0.0, 4.0])]
        return syms_f, mb.general(2, 1).set_iter_colmaj([1.0, 1.0])

    syms_j, c_j = build(jt)
    syms_t, c_t = build(tt)
    rj = jt.ProbSDP(c_j, syms_j).solve(jt.SolverParam(**PARAM))
    pt = tt.ProbSDP(c_t, syms_t, device="cpu")
    _same_data(pt.problem(), jt.ProbSDP(c_j, syms_j).problem())
    rt = pt.solve(tt.SolverParam(**PARAM))
    _same_solve(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), [3.0, 4.0], atol=1e-3)


QCQP1 = dict(p_mats=np.stack([np.eye(2), np.zeros((2, 2))]),
             q_vecs=np.stack([[-5.0, -4.0], [-1.0 / 2.0, -1.0 / 3.0]]),
             r_scls=[0.0, 1.0])


def test_qcqp1():
    # ref totsu/tests/qcqp.rs test_qcqp1 -> (5, 4)
    pj = jqcqp(**QCQP1)
    pt = tt.problems.qcqp(**QCQP1, device="cpu")
    _same_data(pt, pj, rtol=1e-14)
    _same_solve(pt.solve(tt.SolverParam(**PARAM)),
                pj.solve(jt.SolverParam(**PARAM)))


def test_qcqp_class_wrapper():
    p = [np.eye(2), np.zeros((2, 2))]
    rj = jt.ProbQCQP(p, QCQP1["q_vecs"], QCQP1["r_scls"]).solve(
        jt.SolverParam(**PARAM))
    prob = tt.ProbQCQP(p, QCQP1["q_vecs"], QCQP1["r_scls"], device="cpu")
    assert prob.n == 2
    rt = prob.solve(tt.SolverParam(**PARAM))
    _same_solve(rt, rj)
    np.testing.assert_allclose(rt.x.numpy()[:2], [5.0, 4.0], atol=1e-3)


SOCPS = {
    # ref totsu/tests/socp.rs test_socp1 -> (-1, -1)
    "socp1": dict(f=[1.0, 1.0], g_list=[np.eye(2)], h_list=[np.zeros(2)],
                  c_list=[np.zeros(2)], d_list=[np.sqrt(2.0)]),
    # test_socp2: an ni = 0 block beside an ni = 1 block -> (2, 0)
    "socp2": dict(f=[0.0, 1.0],
                  g_list=[np.zeros((0, 2)), np.array([[-1.0, 0.0]])],
                  h_list=[np.zeros(0), np.array([2.0])],
                  c_list=[np.array([0.0, -1.0]), np.array([0.0, 1.0])],
                  d_list=[50.0, 0.0]),
    # ragged blocks with equal-size runs (merged into one factor) and
    # equalities
    "ragged": dict(f=[1.0, -1.0, 0.5],
                   g_list=[np.eye(3)[:2], np.eye(3)[1:], np.zeros((0, 3)),
                           np.zeros((0, 3)), np.ones((1, 3))],
                   h_list=[np.zeros(2), [0.5, 0.0], np.zeros(0),
                           np.zeros(0), [0.1]],
                   c_list=[np.zeros(3), np.zeros(3), [0.0, 1.0, 0.0],
                           [1.0, 0.0, 0.0], np.zeros(3)],
                   d_list=[2.0, 3.0, 0.0, 0.5, 4.0],
                   a=[[1.0, 1.0, 1.0]], b=[0.5]),
}
WANT = {"socp1": [-1.0, -1.0], "socp2": [2.0, 0.0]}


@pytest.mark.parametrize("name", sorted(SOCPS))
def test_socp(name):
    pj = jsocp(**SOCPS[name])
    pt = tt.problems.socp(**SOCPS[name], device="cpu")
    _same_data(pt, pj)
    rj = jt.solve_jit(pj.c, pj.a, pj.b, pj.cone, jt.SolverParam(**PARAM))
    rt = tt.solve_jit(pt.c, pt.a, pt.b, pt.cone, tt.SolverParam(**PARAM))
    _same_solve(rt, rj)
    assert rt.status == tt.SolverStatus.CONVERGED
    if name in WANT:
        np.testing.assert_allclose(rt.x.numpy(), WANT[name], atol=1e-3)


def test_socp_class_wrapper():
    kw = SOCPS["socp2"]
    args = (kw["f"], kw["g_list"], kw["h_list"], kw["c_list"], kw["d_list"])
    rj = jt.ProbSOCP(*args).solve(jt.SolverParam(**PARAM))
    rt = tt.ProbSOCP(*args, device="cpu").solve(tt.SolverParam(**PARAM))
    _same_solve(rt, rj)


def test_builders_keep_tensor_devices_and_default_to_the_card(monkeypatch):
    # tensors keep their device; numpy input goes to the card, so without
    # one it raises (device= names another)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **kw: tt.problems.sdp(**SDP1, **kw),
                  lambda **kw: tt.problems.qcqp(**QCQP1, **kw),
                  lambda **kw: tt.problems.socp(**SOCPS["socp2"], **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        assert build(device="cpu").c.device.type == "cpu"
    f32 = tt.problems.sdp(torch.tensor(SDP1["c"], dtype=torch.float32),
                          torch.tensor(SDP1["f_mats"], dtype=torch.float32))
    assert f32.a.a.dtype == f32.b.dtype == torch.float32
    assert f32.c.device.type == "cpu"


# ---- the partitioning SDP (k = 8) and a nearest-correlation instance


def test_partitioning_dense():
    w, c, f_mats, a, b = cs.make_partitioning(4, 2)
    pj = jsdp(c, f_mats, a, b)
    pt = tt.problems.sdp(c, f_mats, a, b, device="cpu")
    _same_data(pt, pj)
    kw = dict(max_iter=100_000, eps_acc=1e-4)
    rt = pt.solve_jit(tt.SolverParam(**kw))
    _same_solve(rt, pj.solve_jit(jt.SolverParam(**kw)))
    assert rt.status == tt.SolverStatus.CONVERGED


@pytest.mark.parametrize("method", ["eigh", "ns", "jacobi"])
def test_partitioning_structured(method):
    # benchmark_sdp.py's converged_k48 at k = 8, f64: the fast profile
    # keeps PSD layouts of structured operators on pdhg with Halpern
    w, c, neg_d, sel, b = cs.make_partitioning_structured(8)
    c, neg_d, sel, b = (x.astype(np.float64) for x in (c, neg_d, sel, b))
    kw = dict(max_iter=200_000, eps_acc=1e-3, profile="fast")
    rj = jt.solve_jit(jnp.asarray(c), JVStackOp((JDiagOp(jnp.asarray(neg_d)),
                                                JDenseOp(jnp.asarray(sel)))),
                      jnp.asarray(b), jt.ConeLayout(
                          [jt.psd(8, method=method), jt.zero(8)]),
                      jt.SolverParam(**kw))
    op = tt.VStackOp((tt.DiagOp(torch.from_numpy(neg_d)),
                      tt.DenseOp(torch.from_numpy(sel))))
    rt = tt.solve_jit(torch.from_numpy(c), op, torch.from_numpy(b),
                      tt.ConeLayout([tt.psd(8, method=method), tt.zero(8)]),
                      tt.SolverParam(**kw))
    _same_solve(rt, rj)
    assert rt.status == tt.SolverStatus.CONVERGED
    xm = cs.packed_matrix(rt.x.numpy(), 8)
    np.testing.assert_allclose(np.diag(xm), 1.0, atol=1e-2)


def test_nearestcorr_instance():
    # k = 4, the example's parameters, jacobi (the plain version here)
    k = 4
    a, c, sn = cs.nearestcorr_data(k)
    b = cs.nearestcorr_b(cs.make_noisy_covs(1, k)[0])
    kw = dict(max_iter=400_000, eps_acc=1e-4, check_period=25)
    rj = jt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                      jt.ConeLayout([jt.soc(1 + sn), jt.psd(k, method="jacobi"),
                                     jt.zero(k)]), jt.SolverParam(**kw))
    rt = tt.solve_jit(torch.from_numpy(c), torch.from_numpy(a),
                      torch.from_numpy(b),
                      tt.ConeLayout([tt.soc(1 + sn), tt.psd(k, method="jacobi"),
                                     tt.zero(k)]), tt.SolverParam(**kw))
    _same_solve(rt, rj)
    assert rt.status == tt.SolverStatus.CONVERGED


def test_psd_layouts_stay_off_the_megakernel():
    # kernel='mega' refuses PSD and custom layouts, as in the JAX package;
    # the fast profile never picks it for them
    pt = tt.problems.sdp(**SDP1, device="cpu")
    c, a, b = pt.c.float(), pt.a.a.float(), pt.b.float()
    with pytest.raises(ValueError, match="kernel='mega' requires"):
        tt.solve_jit(c, a, b, pt.cone, tt.SolverParam(kernel="mega"))
    lay = tt.ConeLayout([tt.custom(3, lambda x: torch.clamp(x, min=0.0))])
    with pytest.raises(ValueError, match="kernel='mega' requires"):
        tt.solve_jit(c, a, b, lay, tt.SolverParam(kernel="mega"))
    from totsu_tpu_torch.ops.kernels import megakernel as mk
    assert not mk.supported(pt.cone) and not mk.supported(lay)
