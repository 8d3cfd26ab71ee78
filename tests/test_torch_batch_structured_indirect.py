"""Lockstep batches of structured operators on the port's indirect engine
(``method='direct'`` on any operator but a dense one: each lane's
warm-started Jacobi CG on I + A^T A, plain CG for a ``CustomOp``) against
the JAX package's vmapped indirect engine, on the three lanes and seven
forms of ``test_torch_batch_structured.py``. In f64 on the CPU each
lane's status and iteration count must equal JAX's and x agree within
1e-8; lane 0 stops at its cap, so a stopped lane's CG warm start is kept
while the others step."""

import numpy as np
import pytest

from torch_structured import ENGINES, FORMS, assert_lanes_match, run_both
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("form", FORMS)
def test_every_form_matches_jax_lane_for_lane(form):
    """Each form on the indirect engine (Halpern): statuses (one at its
    cap) and iteration counts as JAX's, x within 1e-8; each lane's worst
    CG residual and target are (B,) tensors, the residual within 1% of
    JAX's, the target JAX's."""
    pkw, statuses = ENGINES["direct"]
    rj, rt, _ = run_both(form, pkw)
    assert rt.status.tolist() == statuses
    assert_lanes_match(rj, rt)
    assert tuple(rt.diag["cg_worst_rel"].shape) == (3,)
    np.testing.assert_allclose(rt.diag["cg_worst_rel"].numpy(),
                               np.asarray(rj.diag["cg_worst_rel"]),
                               rtol=1e-2)
    np.testing.assert_array_equal(rt.diag["cg_tol"].numpy(),
                                  np.asarray(rj.diag["cg_tol"]))
    assert rt.diag["cg_steps"] > 0 and rt.diag["cg_solves"] > 0
