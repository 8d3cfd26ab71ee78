"""The port's ``trajsweep_batch`` example at the scaled-down call of
``tests/test_examples.py`` (the companion of ``test_torch_examples.py``,
apart for its time: about 50 s on one CPU core, 33,865 lockstep
iterations of the port's host loop), on the CPU in f64, with its own
self-checks and the JAX package's objectives on the same sweep.
"""

import sys
from pathlib import Path

import numpy as np

from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))


def test_trajsweep_batch():
    from examples_torch import trajsweep_batch
    import trajsweep_batch as jsweep
    objs = trajsweep_batch.main(t_cap=10, caps=(200.0, 300.0, 500.0),
                                cpu=True)
    assert len(objs) == 3
    ref = jsweep.main(t_cap=10, caps=(200.0, 300.0, 500.0))
    np.testing.assert_allclose(objs, ref, rtol=1e-6)
