"""device_idle_pct.<cells>: the share of the traced stretch in which
nothing ran on the device, in %."""

from h100bench import peaks


def read(run):
    return peaks.idle_pct(run)
