"""time_to_solution_s.<cells>: the window, from its start to the end of
its last solve, over the solves that finished in it; each solve is
``solve()`` to the answer on the host, cold."""


def read(run):
    done = len(run.spans)
    return run.window_s / done if done else None
