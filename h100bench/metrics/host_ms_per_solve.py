"""host_ms_per_solve.<cells>: a traced solve's mean wall time less its
megakernel device time, in ms: the entry, routing and set-up around the
one launch (``solve``, ``_resolve_fast_profile``, norms, result)."""

from h100bench import trace


def read(run):
    s = run.tracer.summary
    if s is None or not run.traced_iters:
        return None
    count = len(run.traced_iters)
    wall = sum(t2 - t1 for _, t1, t2 in run.spans[:count])
    return (wall - trace.device_seconds(run, "mega_kernel")) / count * 1e3
