"""Lockstep batches of structured operators in the PyTorch port against
the JAX package on pdhg: ``solve_batch`` on a ``BatchedOp`` and JAX's
``solve_batch`` (``jax.vmap(solve_jit)``) on the same batch-leading
pytree, carried across with ``interop.operator_from_reference(...,
batch=3)``.

Three lanes of the banded box LP (``tests/torch_structured.py``) in seven
operator forms. In f64 on the CPU each lane's status and iteration count
must equal the JAX package's and x agree within 1e-8. ``max_iter`` stops
one lane at its cap while the others converge, so a stopped lane's carry
is exercised. ``test_torch_batch_structured_indirect.py`` holds the same
forms on the indirect engine, ``test_torch_batch_structured_paths.py``
the chunked, meshed, equilibrated and fast-profile paths."""

import pytest

from torch_structured import ENGINES, FORMS, assert_lanes_match, run_both
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("form", FORMS)
def test_every_form_matches_jax_lane_for_lane(form):
    """Each form on pdhg (Halpern, normalized): the lanes' statuses (one
    at its cap) and iteration counts equal the JAX package's, x within
    1e-8, on the lockstep loop."""
    pkw, statuses = ENGINES["pdhg"]
    rj, rt, _ = run_both(form, pkw)
    assert rt.status.tolist() == statuses
    assert_lanes_match(rj, rt)
    assert rt.diag["route"] == "loop"
