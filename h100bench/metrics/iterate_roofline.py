"""iterate_roofline.<cells>: the direct engine's loop body against the HBM
roofline, in %: the traced iterations x (2 m n + n^2) x 4 bytes (as
``direct_iter_roofline``: what the algorithm needs, whatever implements
it) at the peak bandwidth, over the device time of the kernels launched
under the program's ``totsu.loop.iterate`` ranges, which hold exactly
those iterations (so it reads at least ``direct_iter_roofline`` of the
same run)."""

from h100bench import peaks, program_spans

program_spans.install()


def read(run):
    body = program_spans.under(run, "totsu.loop.iterate")
    if body is None or body[0] <= 0 or not sum(run.traced_iters):
        return None
    m, n = run.family.dims(run.config)
    need = (2.0 * m * n + n * n) * 4.0 * sum(run.traced_iters)
    return need / peaks.HBM_BYTES_S / body[0] * 100.0
