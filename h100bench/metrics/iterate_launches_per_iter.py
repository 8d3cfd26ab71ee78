"""iterate_launches_per_iter.<cells>: kernels launched under the program's
``totsu.loop.iterate`` ranges over the traced iterations: the launches of
the host loop's body alone, without the cache build, the border and the
checks that ``launches_per_iter`` counts too."""

from h100bench import program_spans

program_spans.install()


def read(run):
    body = program_spans.under(run, "totsu.loop.iterate")
    if body is None or not sum(run.traced_iters):
        return None
    return body[1] / sum(run.traced_iters)
