"""loop_idle_pct.<cells>: the device's idle share of the loop, in %: over
each traced solve's stretch from the first to the last kernel launched
under the program's ``totsu.loop.iterate`` or ``totsu.loop.check``
ranges, the time in which nothing ran on the device, summed over the
solves, over the stretches summed."""

from h100bench import program_spans

program_spans.install()


def read(run):
    s = run.tracer.summary
    if s is None or not s.get("loop_stretch"):
        return None
    idle, stretch = s["loop_stretch"]
    return idle / stretch * 100.0
