"""Seconds per completed subject that the card sits idle while the host
reads or writes files: the traced window's idle time whose innermost
span of the program is ``ukbb.io.*`` (NIfTI, VTK and CSV; see
``harness/program_spans.py``), over the subjects completed in the
window."""
UNIT, SOURCE, BETTER = "s", "device_trace", "lower"
LAYER, MOVES = "host I/O", "subjects_per_s"
PREFIX = "ukbb.io."


def read(run):
    from benchmark.harness.program_spans import per_subject
    return per_subject(run, PREFIX)
