"""check_pct.<cells>: the device seconds of the kernels launched under the
program's ``totsu.loop.check`` ranges over those under
``totsu.loop.iterate`` and ``totsu.loop.check``, in %: the share of the
loop's device time that its checks take."""

from h100bench import program_spans

program_spans.install()


def read(run):
    check = program_spans.under(run, "totsu.loop.check")
    body = program_spans.under(run, "totsu.loop.iterate")
    if check is None or body is None:
        return None
    return check[0] / (body[0] + check[0]) * 100.0
