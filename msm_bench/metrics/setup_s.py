"""setup_s: process start to the first timed call: library load (and, in a
checkout's first run, its build), points, scalar pool, plan build and the
warm-up calls."""


def read(run):
    return run.setup_s
