"""direct_iter_roofline.<cells>: the direct engine's iterations against
the HBM roofline, in %: iterations x (2 m n + n^2) x 4 bytes (two
products with A and one application of the cached solve of I + A^T A,
each read once: what the algorithm needs, whatever implements it) at
the peak bandwidth, over the device time of every kernel of the traced
stretch (the cache builds included, so the share reads low, never
high)."""

from h100bench import peaks


def read(run):
    return peaks.direct_share(run)
