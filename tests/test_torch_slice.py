"""The port's slice end to end: problem reductions through ``solve`` in both
packages, and the rule that the port never imports JAX.

The reductions take the same numpy / MatBuild inputs in both packages; in
f64 the solves agree on the status, the iteration count and x (1e-8).
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import totsu_tpu as jt
import totsu_tpu_torch as tt
from totsu_tpu.problems import qp as jqp
from totsu_tpu_torch.problems import qp as tqp

PORT = pathlib.Path(tt.__file__).resolve().parent


def _golden_lp(pkg):
    mb = pkg.MatBuild
    return pkg.ProbLP(mb.general(2, 1).set_iter_colmaj([-1., 0.]),
                      mb.general(3, 2).set_iter_colmaj(
                          [4., -1., -1., -1., 4., -1.]),
                      mb.general(3, 1).set_iter_colmaj([6., 6., 1.]))


def test_prob_lp_end_to_end():
    # the golden-log instance (the reference's committed QEMU log)
    rj = _golden_lp(jt).solve(jt.SolverParam(max_iter=100_000))
    rt = _golden_lp(tt).solve(tt.SolverParam(max_iter=100_000))
    assert rt.iters == int(rj.iters) == 160
    assert rt.x.dtype == torch.float64
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(
        rt.x.numpy(), [1.9999994251590176, 2.0000004472430635], atol=1e-9)


@pytest.mark.parametrize("accel", ["", "halpern"])
def test_qp_end_to_end(accel):
    # ref totsu/tests/qp.rs test_qp1: projection onto a halfplane -> (2, 0)
    args = (np.eye(2), [1.0, 2.0], [[-1.0 / 2.0, -1.0 / 3.0]], [-1.0])
    pj = jt.SolverParam(max_iter=100_000, accel=accel)
    rj = jqp(*args).solve(pj)
    prob = tqp(*args)
    assert [f.kind for f in prob.cone.factors] == ["rsoc", "rpos", "zero"]
    rt = prob.solve(tt.SolverParam(max_iter=100_000, accel=accel))
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(rt.x.numpy()[:2], [2.0, 0.0], atol=1e-3)


def test_prob_qp_with_matbuild_and_sqrt():
    def build(pkg):
        sym_p = pkg.MatBuild.sympack(2)
        sym_p[0, 0], sym_p[0, 1], sym_p[1, 1] = 2.0, 0.5, 1.0
        vec_q = pkg.MatBuild.general(2, 1).set_iter_colmaj([1.0, 2.0])
        mat_g = pkg.MatBuild.general(1, 2).set_iter_colmaj([-0.5, -1 / 3])
        vec_h = pkg.MatBuild.general(1, 1).set_iter_colmaj([-1.0])
        return sym_p, pkg.ProbQP(sym_p, vec_q, mat_g, vec_h)

    sp_j, pj = build(jt)
    sp_t, pt = build(tt)
    np.testing.assert_allclose(sp_t.to_dense(), sp_j.to_dense())
    np.testing.assert_allclose(
        sp_t.set_sqrt().to_dense(), sp_j.set_sqrt().to_dense(), atol=1e-14)
    assert pt.n == pj.n == 2
    np.testing.assert_allclose(pt.problem().a.a.numpy(),
                               np.asarray(pj.problem().a.a), atol=1e-14)
    rj = pj.solve(jt.SolverParam(max_iter=100_000))
    rt = pt.solve(tt.SolverParam(max_iter=100_000))
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


def test_reductions_keep_the_input_dtype():
    g = np.array([[-1.0, 0.0], [0.0, -1.0]], np.float32)
    prob = tt.problems.lp(np.ones(2, np.float32), g, np.array(
        [-1.0, -1.0], np.float32))
    assert prob.c.dtype == prob.b.dtype == prob.a.a.dtype == torch.float32
    res = prob.solve(tt.SolverParam(max_iter=10_000, eps_acc=1e-3))
    np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=1e-2)


def test_port_never_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
    # and importing the whole port pulls in no JAX module
    code = ("import sys, totsu_tpu_torch, totsu_tpu_torch.interop, "
            "totsu_tpu_torch.ops.kernels.megakernel; "
            "print(sorted(m for m in sys.modules if m in ('jax', "
            "'totsu_tpu') or m.startswith(('jax.', 'jaxlib', "
            "'totsu_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PORT.parent, check=True)
    assert out.stdout.strip() == "[]"
