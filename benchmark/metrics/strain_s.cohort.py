"""Mean over the window's subjects of the cohort's own seconds for its
``strain`` stage (``CohortResult.stage_seconds``)."""
UNIT, SOURCE, BETTER = "s", "program_span", "lower"
LAYER, MOVES = "strain and registration", "subjects_per_s"
STAGE = "strain"


def read(run):
    got = [p.stages[STAGE] for p in run.record.get("passes", ())
           if p.ok and STAGE in p.stages]
    return sum(got) / len(got) if got else None
