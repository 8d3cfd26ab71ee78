"""latency_p95_ms.<cells>: the 95th percentile, over every request of the
window, of its latency in ms: a closed loop's from the call to its
answer, an open loop's from when the request was due (a stall delays
the requests behind it too)."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies), 95)) * 1e3
