"""The card's idle time assigned to the program's spans
(``harness/program_spans.py``) on synthetic traces: the innermost span
wins, idle time under no ``ukbb.`` span counts toward no layer, busy time
counts toward none, and the readers divide by the completed subjects."""

from types import SimpleNamespace

import pytest

from benchmark.harness import program_spans
from benchmark.harness.spec import reader
from benchmark.harness.trace import Trace

NS = 1e-9


def _trace():
    # busy [10, 20) and [60, 70); window [0, 100)
    dev = [(10, 20, "k1"), (60, 70, "k2")]
    host = [(0, 95, "ukbb.subject"),
            (0, 50, "ukbb.stage.segment"),
            (5, 40, "ukbb.io.nifti.save"),
            (30, 35, "ukbb.program.replay"),
            (50, 90, "ukbb.stage.strain"),
            (55, 80, "ukbb.phenotype.strain.tables"),
            (75, 85, "ukbb.io.csv"),
            (0, 100, "bench:subject"),
            (40, 100, "aten::copy_")]
    return Trace(dev, host, (0, 100))


def test_idle_gaps_are_the_complement_of_busy_inside_the_window():
    assert program_spans.idle_gaps(_trace()) == [(0, 10), (20, 60),
                                                 (70, 100)]
    t = Trace([(-5, 3, "k"), (98, 120, "k")], [], (0, 100))
    assert program_spans.idle_gaps(t) == [(3, 98)]
    assert program_spans.idle_gaps(Trace([(0, 100, "k")], [], (0, 100))) == []


def test_innermost_span_wins_and_busy_time_counts_toward_none():
    got = {k: round(v / NS) for k, v in
           program_spans.idle_by_span(_trace()).items()}
    assert got == {
        # [0, 5) under the stage alone; [5, 10) and [20, 30), [35, 40)
        # under the save; the replay is shorter: [30, 35)
        "ukbb.stage.segment": 5 + 10,
        "ukbb.io.nifti.save": 5 + 10 + 5,
        "ukbb.program.replay": 5,
        "ukbb.stage.strain": 5 + 5,            # [50, 55), [85, 90)
        "ukbb.phenotype.strain.tables": 5 + 5,  # [55, 60), [70, 75)
        "ukbb.io.csv": 10,                     # [75, 85)
        "ukbb.subject": 5,                     # [90, 95)
        None: 5,                               # [95, 100): no ukbb. span
    }
    # the whole idle time is assigned once, the busy 20 ns never
    assert sum(got.values()) == 100 - 20


def test_layers_and_leaf_share():
    t = _trace()
    assert program_spans.idle_seconds(t, "ukbb.io.") == pytest.approx(30 * NS)
    assert program_spans.idle_seconds(t, "ukbb.phenotype.") == \
        pytest.approx(10 * NS)
    assert program_spans.idle_seconds(t, "ukbb.program.") == \
        pytest.approx(5 * NS)
    # leaves: io 30 + replay 5 + tables 10 of 80 idle
    assert program_spans.leaf_share(t) == pytest.approx(45 / 80)


def test_a_program_without_spans_reads_zero_and_no_trace_reads_none():
    t = Trace([(10, 20, "k1")], [(0, 100, "bench:subject")], (0, 100))
    assert program_spans.idle_by_span(t) == {None: pytest.approx(90 * NS)}
    passes = [SimpleNamespace(ok=True)]
    for name in ("idle_io_s.cohort", "idle_phenotype_s.cohort",
                 "idle_programs_s.cohort"):
        r = reader(name)
        assert r.read(SimpleNamespace(trace=t, record={"passes": passes})) \
            == 0.0
        assert r.read(SimpleNamespace(trace=None,
                                      record={"passes": passes})) is None


def test_readers_divide_by_the_completed_subjects():
    passes = [SimpleNamespace(ok=True), SimpleNamespace(ok=False),
              SimpleNamespace(ok=True)]
    run = SimpleNamespace(trace=_trace(), record={"passes": passes})
    assert reader("idle_io_s.cohort").read(run) == pytest.approx(15 * NS)
    assert reader("idle_phenotype_s.cohort").read(run) == \
        pytest.approx(5 * NS)
    assert reader("idle_programs_s.cohort").read(run) == \
        pytest.approx(2.5 * NS)
