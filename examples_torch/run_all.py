"""Run every example end to end (port of ``examples/run_all.py``, the
reference's exec_all.sh). ``--cpu`` runs on the CPU in f64; the default
is the CUDA card in f32.

    python examples_torch/run_all.py [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch import (boxdesign_gp, fit_qp, growthport_powexp,
                            imgnr_udef, l1reg_lp, leastsq_qp,
                            logreg_expcone, mpc_qp, nearestcorr_batch_sdp,
                            partitioning_sdp, svm_qp, toruscompl_socp,
                            trajplan_qcqp, trajsweep_batch)

#: every example, in the JAX package's run_all order (leastsq_qp after
#: the others: the JAX run_all leaves it out)
EXAMPLES = (l1reg_lp, svm_qp, trajplan_qcqp, toruscompl_socp,
            partitioning_sdp, imgnr_udef, trajsweep_batch,
            nearestcorr_batch_sdp, growthport_powexp, boxdesign_gp,
            logreg_expcone, fit_qp, mpc_qp, leastsq_qp)


def main(cpu=None):
    t0 = time.time()
    for example in EXAMPLES:
        example.main(cpu=cpu)
    print(f"[run_all] all {len(EXAMPLES)} examples OK in "
          f"{time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
