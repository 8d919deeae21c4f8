"""Subjects completed over the window's seconds on the harness's clock,
from its start to the end of the last subject."""
UNIT, SOURCE, BETTER, LAYER, MOVES = "subjects/s", "host_clock", "higher", None, None


def read(run):
    passes = run.record.get("passes")
    if not passes:
        return None
    return sum(p.ok for p in passes) / run.record["window_s"]
