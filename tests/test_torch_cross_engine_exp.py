"""pdhg against the direct engine in the PyTorch port against the JAX
package: the exp and mixed-cone cases of ``tests/test_cross_engine.py``
(the others are in ``test_torch_cross_engine.py``, whose checks these
share). The mixed instance at seed 2 takes 13,700 pdhg iterations, about
70 s of the port's host loop on one CPU core (the plain exp/pow root
finders and the PSD eigh, about 5 ms an iteration), so this file runs
over the minute the others keep to.
"""

import pytest

import totsu_tpu as jt
from test_torch_cross_engine import check_case
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

CASES = [
    ("exp", [jt.expc(count=3), jt.rpos(2)]),
    ("mixed", [jt.zero(1), jt.soc(3), jt.expc(count=2), jt.powc(0.6),
               jt.psd(2)]),
]


@pytest.mark.parametrize("name,factors", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pdhg_vs_direct_agree(name, factors, seed):
    check_case(factors, seed)
