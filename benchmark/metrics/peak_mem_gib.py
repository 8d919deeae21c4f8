"""The card memory the process held at its peak, set-up and window
(``torch.cuda.max_memory_reserved``)."""
UNIT, SOURCE, BETTER, LAYER, MOVES = "GiB", "host_clock", "lower", None, None


def read(run):
    return run.peak_reserved_bytes / 2 ** 30
