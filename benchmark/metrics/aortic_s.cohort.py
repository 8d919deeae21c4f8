"""Mean over the window's subjects of the cohort's own seconds for its
``aortic`` stage (``CohortResult.stage_seconds``)."""
UNIT, SOURCE, BETTER = "s", "program_span", "lower"
LAYER, MOVES = "aortic engine and areas", "subjects_per_s"
STAGE = "aortic"


def read(run):
    got = [p.stages[STAGE] for p in run.record.get("passes", ())
           if p.ok and STAGE in p.stages]
    return sum(got) / len(got) if got else None
