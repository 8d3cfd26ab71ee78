"""mega_roofline.<cells>: the megakernel's share of its roofline, in %:
8 m n operations a lane-iteration, summed over each lane's own ``iters``
in the traced stretch, at the f32 peak, over the megakernel's device
time there. The count is of the work these inputs need, whatever
implements it."""

from h100bench import peaks


def read(run):
    return peaks.mega_share(run)
