"""Share of the traced window in which no kernel, copy or set ran on the
card (device intervals from the profiler, merged), in the TransUNet
deploy cell."""
UNIT, SOURCE, BETTER = "%", "device_trace", "lower"
LAYER, MOVES = "device", "subjects_per_s"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
