"""The port's examples (``examples_torch/``) at the scaled-down calls of
``tests/test_examples.py``, on the CPU in f64 (``cpu=True``), each with
its own self-checks, and held against the JAX package's examples
(``examples/``) run on the same data: for the batch examples the same
statuses and iteration counts, objectives and x to 1e-6; for the others
the number each ``main`` returns (an objective, an error or a cut) to
1e-6 relative (1e-5 where the solve stops at eps_acc 1e-3, where the
port's and JAX's roundoff can end the run a check period apart).

Also: nothing in ``examples_torch/`` imports ``jax`` or ``totsu_tpu``,
and importing them with the batch modules pulls in no JAX module.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))


def test_mpc_qp():
    from examples_torch import mpc_qp
    import mpc_qp as jmpc
    # same fleet, warm vs cold: warm-started ticks must need fewer total
    # iterations (the disturbances are seeded, so runs are comparable)
    warm = mpc_qp.main(n_vehicles=3, h_horizon=4, ticks=10, cpu=True)
    cold = mpc_qp.main(n_vehicles=3, h_horizon=4, ticks=10, use_warm=False,
                       cpu=True)
    assert sum(warm) < sum(cold), (warm, cold)
    # the JAX package's runner on the same fleet: the same iterations per
    # tick (the batch's slowest lane)
    assert warm == jmpc.main(n_vehicles=3, h_horizon=4, ticks=10)


def test_nearestcorr_batch_sdp():
    from examples_torch import nearestcorr_batch_sdp as nc
    import nearestcorr_batch_sdp as jnc
    res = nc.main(batch=4, k=5, cpu=True)
    ref = jnc.main(batch=4, k=5)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-6)


def _twin(name, rtol, **kw):
    """The port's example ``name`` and the JAX package's, both run with
    ``kw``: each passes its self-checks, and their returned numbers
    agree to ``rtol``."""
    import importlib
    port = importlib.import_module(f"examples_torch.{name}").main(
        **kw, cpu=True)
    ref = importlib.import_module(name).main(**kw)
    np.testing.assert_allclose(port, ref, rtol=rtol)
    return port


def test_l1reg_lp():
    _twin("l1reg_lp", 1e-5, l=10)


def test_svm_qp():
    _twin("svm_qp", 1e-5, l=20)


def test_trajplan_qcqp():
    _twin("trajplan_qcqp", 1e-5, t_cap=12, a_cap=300.0)


def test_toruscompl_socp():
    _twin("toruscompl_socp", 1e-5, x_num=5, y_num=4)


def test_partitioning_sdp():
    # the best rounded cut: the same cut, so the same value
    _twin("partitioning_sdp", 1e-12, x_num=4, y_num=3)


def test_imgnr_udef():
    _twin("imgnr_udef", 1e-5, w=24, h=24, ratio=0.01)


def test_leastsq_qp():
    _twin("leastsq_qp", 1e-6, mrows=30, n=8)


def test_growthport_powexp():
    _twin("growthport_powexp", 1e-6, n=4, s_num=4, h_budget=-1.0)


def test_boxdesign_gp():
    _twin("boxdesign_gp", 1e-6)


def test_logreg_expcone():
    _twin("logreg_expcone", 1e-6, m=24, n=6)


def _jax_fit_qp(n, n_obs, steps):
    """``examples/fit_qp.py``'s fit, step for step (the same draws of
    ``default_rng(0)``, the same Adam), returning what its ``main`` only
    prints: (first loss, final loss, held-out max error, fitted theta)."""
    import jax
    import jax.numpy as jnp
    import totsu_tpu as jt
    from totsu_tpu.diff import make_differentiable_solver

    rng = np.random.default_rng(0)
    p_true = jnp.asarray(rng.random(n) + 0.5)
    q_true = jnp.asarray(rng.normal(size=n) * 0.3)
    shifts = jnp.asarray(rng.normal(size=(n_obs, n)) * 0.2)
    eye = np.eye(n)
    g = jnp.asarray(np.concatenate([eye, -eye]))
    h = jnp.ones((2 * n,))
    lay = jt.problems.qp(jnp.diag(p_true), q_true, g=g, h=h).cone
    solver = make_differentiable_solver(lay, jt.SolverParam(
        max_iter=200_000, eps_acc=1e-9, method="direct"))

    def solve_x(pdiag, q, shift):
        prob = jt.problems.qp(jnp.diag(pdiag), q + shift, g=g, h=h)
        return solver(prob.c, prob.a.a, prob.b)[0][:n]

    x_obs = jax.vmap(lambda s: solve_x(p_true, q_true, s))(shifts)

    def loss(theta):
        pdiag = jax.nn.softplus(theta[:n]) + 0.1
        xs = jax.vmap(lambda s: solve_x(pdiag, theta[n:], s))(shifts)
        return jnp.mean(jnp.sum((xs - x_obs) ** 2, axis=-1))

    theta = jnp.concatenate([
        jnp.asarray(rng.normal(size=n) * 0.3), jnp.zeros(n)])
    val_grad = jax.jit(jax.value_and_grad(loss))
    mt = vt = jnp.zeros_like(theta)
    lr, b1, b2 = 0.1, 0.9, 0.999
    l0 = None
    for k in range(steps):
        lv, gv = val_grad(theta)
        if l0 is None:
            l0 = float(lv)
        mt = b1 * mt + (1 - b1) * gv
        vt = b2 * vt + (1 - b2) * gv * gv
        mh = mt / (1 - b1 ** (k + 1))
        vh = vt / (1 - b2 ** (k + 1))
        theta = theta - lr * mh / (jnp.sqrt(vh) + 1e-8)
    l_fin = float(loss(theta))
    s_new = jnp.asarray(rng.normal(size=(3, n)) * 0.2)
    x_t = jax.vmap(lambda s: solve_x(p_true, q_true, s))(s_new)
    x_f = jax.vmap(lambda s: solve_x(jax.nn.softplus(theta[:n]) + 0.1,
                                     theta[n:], s))(s_new)
    return l0, l_fin, float(jnp.max(jnp.abs(x_t - x_f))), np.asarray(theta)


def test_fit_qp():
    # the JAX example only prints its numbers, so its fit is rebuilt here
    # (the example's main itself runs in tests/test_examples.py): in f64
    # both solve with the direct method to eps_acc 1e-9 and take the same
    # 80 Adam steps from the same draws, so the losses, the held-out error
    # and the fitted parameters agree to 1e-6
    from examples_torch import fit_qp
    l0, l_fin, held, theta = fit_qp.main(n=3, n_obs=3, steps=80, cpu=True)
    assert l_fin < 1e-2 * l0 and held < 5e-2
    ref = _jax_fit_qp(n=3, n_obs=3, steps=80)
    np.testing.assert_allclose((l0, l_fin, held), ref[:3], rtol=1e-6)
    np.testing.assert_allclose(theta.numpy(), ref[3], rtol=1e-6, atol=1e-9)


def test_run_all_lists_every_example():
    from examples_torch import run_all
    ported = {p.stem for p in (ROOT / "examples_torch").glob("*.py")
              if not p.stem.startswith("_")} - {"run_all"}
    assert {m.__name__.rsplit(".", 1)[-1] for m in run_all.EXAMPLES} \
        == ported
    assert ported == {p.stem for p in (ROOT / "examples").glob("*.py")
                      if not p.stem.startswith("_")} - {"run_all"}


def test_plot_needs_matplotlib(monkeypatch):
    # --plot imports matplotlib only when asked, and raises without it
    import builtins
    from examples_torch import _plot
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    monkeypatch.setattr(sys, "argv", ["l1reg_lp.py", "--plot"])
    assert _plot.enabled()
    with pytest.raises(RuntimeError, match="matplotlib"):
        _plot.pyplot()
    from examples_torch import l1reg_lp
    with pytest.raises(RuntimeError, match="matplotlib"):
        l1reg_lp.main(l=6, cpu=True)


def test_examples_need_a_card_unless_told(monkeypatch):
    import torch
    from examples_torch import _common
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TOTSU_CPU", raising=False)
    with pytest.raises(RuntimeError, match="--cpu"):
        _common.setup(cpu=False)
    assert _common.setup(cpu=True)[:2] == (torch.device("cpu"),
                                           torch.float64)


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|totsu_tpu)(?![\w])", re.M)


def test_examples_and_batch_modules_never_import_jax():
    files = sorted((ROOT / "examples_torch").glob("*.py"))
    assert len(files) >= 17
    offenders = [str(p) for p in files if _FORBIDDEN.search(p.read_text())]
    assert offenders == []
    code = ("import sys, totsu_tpu_torch.parallel, totsu_tpu_torch.runtime, "
            "totsu_tpu_torch.solver.batched, examples_torch.run_all, "
            "examples_torch._plot; "
            "print(sorted(m for m in sys.modules if m in ('jax', "
            "'totsu_tpu') or m.startswith(('jax.', 'jaxlib', "
            "'totsu_tpu.'))))")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True, env=env)
    assert out.stdout.strip() == "[]"
