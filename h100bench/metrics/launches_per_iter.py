"""launches_per_iter.<cells>: kernels launched in the traced stretch over
the iterations of its solves: the host loop's launches an iteration."""

from h100bench import trace


def read(run):
    if run.tracer.summary is None or not sum(run.traced_iters):
        return None
    return trace.launches(run) / sum(run.traced_iters)
