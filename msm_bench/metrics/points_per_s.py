"""points_per_s: points of every MSM completed in the window (n times the
scalar sets of every call) over the window's wall time."""


def read(run):
    return run.n * run.msms / run.window_s
