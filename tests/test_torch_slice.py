"""The port's slice end to end: problem reductions through ``solve`` in both
packages, the rule that the port never imports JAX, and the rule that data
that is not a tensor goes to the CUDA card unless the caller asks for
another device.

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
from totsu_tpu_torch import interop
from totsu_tpu_torch.problems import qp as tqp

PORT = pathlib.Path(tt.__file__).resolve().parent


def _golden_lp(pkg, **kw):
    mb = pkg.MatBuild
    return pkg.ProbLP(mb.general(2, 1).set_iter_colmaj([-1., 0.]),
                      mb.general(3, 2).set_iter_colmaj(
                          [4., -1., -1., -1., 4., -1.]),
                      mb.general(3, 1).set_iter_colmaj([6., 6., 1.]), **kw)


def test_prob_lp_end_to_end():
    # the golden-log instance (the reference's committed QEMU log)
    rj = _golden_lp(jt).solve(jt.SolverParam(max_iter=100_000))
    rt = _golden_lp(tt, device="cpu").solve(tt.SolverParam(max_iter=100_000))
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
    prob = tqp(*args, device="cpu")
    assert [f.kind for f in prob.cone.factors] == ["rsoc", "rpos", "zero"]
    rt = prob.solve(tt.SolverParam(max_iter=100_000, accel=accel))
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(rt.x.numpy()[:2], [2.0, 0.0], atol=1e-3)


def test_prob_qp_with_matbuild_and_sqrt():
    def build(pkg, **kw):
        sym_p = pkg.MatBuild.sympack(2)
        sym_p[0, 0], sym_p[0, 1], sym_p[1, 1] = 2.0, 0.5, 1.0
        vec_q = pkg.MatBuild.general(2, 1).set_iter_colmaj([1.0, 2.0])
        mat_g = pkg.MatBuild.general(1, 2).set_iter_colmaj([-0.5, -1 / 3])
        vec_h = pkg.MatBuild.general(1, 1).set_iter_colmaj([-1.0])
        return sym_p, pkg.ProbQP(sym_p, vec_q, mat_g, vec_h, **kw)

    sp_j, pj = build(jt)
    sp_t, pt = build(tt, device="cpu")
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
        [-1.0, -1.0], np.float32), device="cpu")
    assert prob.c.dtype == prob.b.dtype == prob.a.a.dtype == torch.float32
    res = prob.solve(tt.SolverParam(max_iter=10_000, eps_acc=1e-3))
    np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=1e-2)


# an import of jax or of the JAX package (not of totsu_tpu_torch)
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|totsu_tpu)(?![\w])", re.M)


@pytest.mark.parametrize("line", [
    "import jax", "from jax import numpy", "import jax.numpy as jnp",
    "import totsu_tpu", "from totsu_tpu.solver import cone",
    "    from totsu_tpu import problems", "import jaxlib",
])
def test_forbidden_import_pattern_matches(line):
    assert _FORBIDDEN.search(line)


@pytest.mark.parametrize("line", [
    "import totsu_tpu_torch", "from totsu_tpu_torch.solver import cone",
    "import jaxtyping", "# import jax in a comment", "x = 'import jax'",
])
def test_forbidden_import_pattern_spares(line):
    assert not _FORBIDDEN.search(line)


def test_port_never_imports_jax():
    # the package and chip_smoke.py import neither jax nor totsu_tpu
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert (PORT.parent / "chip_smoke.py").exists()
    offenders = [str(p) for p in files if _FORBIDDEN.search(p.read_text())]
    assert offenders == []
    # and importing the whole port pulls in no JAX module
    code = ("import sys, totsu_tpu_torch, totsu_tpu_torch.interop, "
            "totsu_tpu_torch.ops.kernels.megakernel, "
            "totsu_tpu_torch.ops.kernels.cone_proj, "
            "totsu_tpu_torch.solver.direct, "
            "totsu_tpu_torch.solver.scaling, "
            "totsu_tpu_torch.solver.api, totsu_tpu_torch.utils.env, "
            "totsu_tpu_torch.problems.gp, totsu_tpu_torch.problems.sdp, "
            "totsu_tpu_torch.problems.socp, totsu_tpu_torch.problems.qcqp, "
            "totsu_tpu_torch.ops.jacobi, "
            "totsu_tpu_torch.ops.kernels.psd_jacobi, "
            "totsu_tpu_torch.utils.operator_check, "
            "totsu_tpu_torch.utils.contour, totsu_tpu_torch.diff, "
            "totsu_tpu_torch.solver.dproj, totsu_tpu_torch.solver.polish; "
            "print(sorted(m for m in sys.modules if m in ('jax', "
            "'totsu_tpu') or m.startswith(('jax.', 'jaxlib', "
            "'totsu_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PORT.parent, check=True)
    assert out.stdout.strip() == "[]"


def _no_cuda(monkeypatch):
    # the card is absent here; make it so wherever the tests run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("build", [
    lambda: interop.problem_from_numpy([1.0], [[1.0]], [1.0]),
    lambda: tt.problems.lp(np.ones(2), -np.eye(2), -np.ones(2)),
    lambda: tt.problems.qp(np.eye(2), [1.0, 2.0]),
    lambda: tt.problems.gp([[1.0]], [[[-1.0]]]),
    lambda: _golden_lp(tt),
    lambda: tt.ProbQP(np.eye(2), [1.0, 2.0]),
    lambda: tt.solve(np.ones(2), -np.eye(2), -np.ones(2),
                     tt.ConeLayout([tt.rpos(2)])),
    lambda: tt.solve_jit(np.ones(2), -np.eye(2), -np.ones(2),
                         tt.ConeLayout([tt.rpos(2)])),
    lambda: tt.DiagOp([1.0, 2.0]),
    lambda: tt.ZeroOp(2, 2),
    lambda: tt.SparseOp.from_dense(np.eye(2)),
    lambda: tt.BlockedEllOp.from_dense(np.eye(2), block=(1, 1)),
    lambda: tt.CustomOp(params=None, m=2, n=2, matvec_fn=lambda p, x: x),
], ids=["problem_from_numpy", "lp", "qp", "gp", "ProbLP", "ProbQP",
        "solve", "solve_jit", "DiagOp", "ZeroOp", "SparseOp",
        "BlockedEllOp", "CustomOp"])
def test_numpy_input_targets_cuda(build, monkeypatch):
    # data that is not a tensor goes to the card unless device= says
    # otherwise: without a card that raises, it never runs on the CPU
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_tensors_keep_their_device(monkeypatch):
    # CPU tensors stay on the CPU without device=, and numpy data beside
    # them follows them
    _no_cuda(monkeypatch)
    g = torch.tensor([[-1.0, 0.0], [0.0, -1.0]], dtype=torch.float64)
    prob = tt.problems.lp(torch.ones(2, dtype=torch.float64), g,
                          np.array([-1.0, -1.0]))
    assert prob.b.device.type == prob.a.a.device.type == "cpu"
    res = tt.solve(prob.c, prob.a, [-1.0, -1.0], prob.cone,
                   tt.SolverParam(max_iter=10_000, eps_acc=1e-3))
    np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=1e-2)
    c, a, b = interop.problem_from_numpy([1.0], [[1.0]], [1.0],
                                         device="cpu")
    assert c.device == a.device == b.device == torch.device("cpu")


def test_tensor_on_another_device_than_asked_raises():
    # device= names where the solve runs; a tensor A elsewhere is an error,
    # not a silent choice of one of the two
    a = -torch.eye(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="not on device=cuda"):
        tt.solve(np.ones(2), a, -np.ones(2), tt.ConeLayout([tt.rpos(2)]),
                 device="cuda")
    res = tt.solve(np.ones(2), a, -np.ones(2), tt.ConeLayout([tt.rpos(2)]),
                   tt.SolverParam(max_iter=10_000, eps_acc=1e-3),
                   device="cpu")
    assert res.x.device.type == "cpu"
