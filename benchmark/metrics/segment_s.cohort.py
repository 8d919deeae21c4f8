"""Mean over the window's subjects of the cohort's own seconds for its
``segment`` stage (``CohortResult.stage_seconds``)."""
UNIT, SOURCE, BETTER = "s", "program_span", "lower"
LAYER, MOVES = "SA engine", "subjects_per_s"
STAGE = "segment"


def read(run):
    got = [p.stages[STAGE] for p in run.record.get("passes", ())
           if p.ok and STAGE in p.stages]
    return sum(got) / len(got) if got else None
