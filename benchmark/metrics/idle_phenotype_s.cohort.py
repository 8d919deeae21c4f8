"""Seconds per completed subject that the card sits idle in the phenotype
stages' host work: the traced window's idle time whose innermost span of
the program is ``ukbb.phenotype.*`` (volumes, QC, wall thickness, the
strain stage's crop, contours, fetch and tables, the aortic QC and
areas; see ``harness/program_spans.py``), over the subjects completed in
the window."""
UNIT, SOURCE, BETTER = "s", "device_trace", "lower"
LAYER, MOVES = "phenotype host work", "subjects_per_s"
PREFIX = "ukbb.phenotype."


def read(run):
    from benchmark.harness.program_spans import per_subject
    return per_subject(run, PREFIX)
