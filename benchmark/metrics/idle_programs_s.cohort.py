"""Seconds per completed subject that the card sits idle in the CUDA
graphs' own host work: the traced window's idle time whose innermost
span of the program is ``ukbb.program.*`` (a key's first eager call, its
capture, a replay's copy-in and copy-out, and the release of dropped
programs' pools; see ``harness/program_spans.py``), over the subjects
completed in the window."""
UNIT, SOURCE, BETTER = "s", "device_trace", "lower"
LAYER, MOVES = "programs", "subjects_per_s"
PREFIX = "ukbb.program."


def read(run):
    from benchmark.harness.program_spans import per_subject
    return per_subject(run, PREFIX)
