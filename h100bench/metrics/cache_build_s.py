"""cache_build_s.<cells>: device seconds of the kernels launched under the
program's ``totsu.direct.cache`` range, per traced solve: the direct
engine's I + A^T A and its Newton-Schulz inverse (``spd_cache``)."""

from h100bench import program_spans

program_spans.install()


def read(run):
    cache = program_spans.under(run, "totsu.direct.cache")
    if cache is None or not run.traced_iters:
        return None
    return cache[0] / len(run.traced_iters)
