"""latency_p50_ms.<cells>: the median request latency from its due time,
in ms: what BatchRunner's collector and drains cost a typical request."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies), 50)) * 1e3
