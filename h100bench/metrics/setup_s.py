"""setup_s: seconds from the process's start to the window's: imports,
the card's start-up, loading (or, in a checkout's first run, building)
the kernels, making the instances and warming up the cell's shapes."""


def read(run):
    return run.setup_s
