"""The port's batch examples (``examples_torch/``) at the scaled-down
calls of ``tests/test_examples.py``, on the CPU in f64 (``cpu=True``),
each with its own self-checks, and held against the JAX package's
examples (``examples/``) run on the same data: the same statuses and
iteration counts, objectives and x to 1e-6.

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
    assert len(files) >= 5
    offenders = [str(p) for p in files if _FORBIDDEN.search(p.read_text())]
    assert offenders == []
    code = ("import sys, totsu_tpu_torch.parallel, totsu_tpu_torch.runtime, "
            "totsu_tpu_torch.solver.batched, examples_torch.mpc_qp, "
            "examples_torch.nearestcorr_batch_sdp, "
            "examples_torch.trajsweep_batch; "
            "print(sorted(m for m in sys.modules if m in ('jax', "
            "'totsu_tpu') or m.startswith(('jax.', 'jaxlib', "
            "'totsu_tpu.'))))")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True, env=env)
    assert out.stdout.strip() == "[]"
