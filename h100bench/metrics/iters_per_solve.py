"""iters_per_solve.<cells>: the mean of the answers' ``iters`` (the
engine's own count: a batch lane's, or ``SolveResult.iters``) over
every answer in the window."""


def read(run):
    return sum(run.iters) / len(run.iters) if run.iters else None
