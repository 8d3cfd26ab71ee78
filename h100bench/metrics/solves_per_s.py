"""solves_per_s: lanes solved (CONVERGED) in the window over the
window's seconds, from its start to the return of its last call."""


def read(run):
    return run.solved / run.window_s if run.window_s > 0 else None
