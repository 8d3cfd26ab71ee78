"""The card's peaks and the operations and bytes of the port's work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of
HBM. A share of a peak is given against these, whatever the card's power
limit; the run's card and limit go beside the number in PERF.md.
"""

from h100bench import trace

F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12


def mega_share(run):
    """% of the f32 roofline of the megakernel's traced launches: 8 m n
    operations a lane-iteration (two matvec pairs with A), A being read
    from HBM once a solve, so bound by operations."""
    if run.tracer.summary is None or not run.traced_iters:
        return None
    t = trace.device_seconds(run, "mega_kernel")
    if t <= 0:
        return None
    m, n = run.family.dims(run.config)
    ops = 8.0 * m * n * sum(run.traced_iters)
    return ops / F32_FLOPS / t * 100.0


def direct_share(run):
    """% of the HBM roofline of the direct engine's traced iterations:
    (2 m n + n^2) f32 words an iteration, over all device time."""
    if run.tracer.summary is None or not run.traced_iters:
        return None
    t = trace.device_seconds(run)
    if t <= 0:
        return None
    m, n = run.family.dims(run.config)
    need = (2.0 * m * n + n * n) * 4.0 * sum(run.traced_iters)
    return need / HBM_BYTES_S / t * 100.0


def idle_pct(run):
    """% of the traced stretch in which nothing ran on the device."""
    s = run.tracer.summary
    if s is None or s["window_s"] <= 0:
        return None
    return (1.0 - s["busy_s"] / s["window_s"]) * 100.0
