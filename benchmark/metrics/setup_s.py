"""Seconds from the process's start to the window's start."""
UNIT, SOURCE, BETTER, LAYER, MOVES = "s", "host_clock", "lower", None, None


def read(run):
    return run.setup_s
