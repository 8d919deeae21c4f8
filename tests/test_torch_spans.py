"""The port's profiler spans (``utils/timing.py::span``) on the CPU.

A one-subject SA cohort and a one-subject aortic ``run_cohort_full`` run
under ``torch.profiler``: the ``ukbb.`` spans of the vocabulary appear
and nest as documented, and each ``ukbb.stage.*`` span lasts what its
``stage_seconds`` entry says (within 5 ms plus 5 %); the cohorts' NIfTI
writes open no ``ukbb.io.nifti.reorder`` span, and a save of C-ordered
voxels opens one.  With no profiler running a span never calls
``record_function``; no span opens inside a function that a program
captures; ``run_cohort --trace_dir`` writes the spans into its Chrome
trace.  The program spans around a real capture
and its replays are checked on the card (``tests/test_torch_card.py``).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_cohort import AO_BUNDLE, _ao_only_subject
from test_torch_la import write_full_subject
from ukbb_cardiac_tpu_torch.cli import run_cohort
from ukbb_cardiac_tpu_torch.infer.deploy import load_segmentation_model
from ukbb_cardiac_tpu_torch.infer.deploy_ao import load_aortic_engine
from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.parallel import run_cohort_full, run_cohort_sa
from ukbb_cardiac_tpu_torch.phenotype.qc import aorta_pass_quality_control
from ukbb_cardiac_tpu_torch.reg import programs
from ukbb_cardiac_tpu_torch.utils import timing
from ukbb_cardiac_tpu_torch.utils.timing import StageTimer, span

torch.set_num_threads(1)

WEIGHTS = os.path.join(os.path.dirname(__file__), "fixtures",
                       "bench_weights")
SA_BUNDLE = os.path.join(WEIGHTS, "FCN_sa.npz")
CAPTURED = "test.captured"

# span -> the span it lies in (the innermost of the vocabulary)
SA_PARENTS = {
    "ukbb.stage.segment": "ukbb.subject",
    "ukbb.stage.volumes": "ukbb.subject",
    "ukbb.stage.wall_thickness": "ukbb.subject",
    "ukbb.stage.strain": "ukbb.subject",
    "ukbb.engine.dispatch": "ukbb.stage.segment",
    "ukbb.engine.wait": "ukbb.stage.segment",
    "ukbb.deploy.write": "ukbb.stage.segment",
    "ukbb.phenotype.volumes": "ukbb.stage.volumes",
    "ukbb.phenotype.qc": "ukbb.stage.wall_thickness",
    "ukbb.phenotype.wall_thickness": "ukbb.stage.wall_thickness",
    "ukbb.phenotype.strain.crop": "ukbb.stage.strain",
    "ukbb.phenotype.strain.contours": "ukbb.stage.strain",
    "ukbb.reg.dispatch": "ukbb.stage.strain",
    "ukbb.phenotype.strain.fetch": "ukbb.stage.strain",
    "ukbb.phenotype.strain.tables": "ukbb.stage.strain",
}
AO_PARENTS = {
    "ukbb.stage.segment_la": "ukbb.subject",
    "ukbb.stage.atrial_volumes": "ukbb.subject",
    "ukbb.stage.strain_la": "ukbb.subject",
    "ukbb.stage.aortic": "ukbb.subject",
    "ukbb.phenotype.atrial_volumes": "ukbb.stage.atrial_volumes",
    "ukbb.engine.dispatch": "ukbb.stage.aortic",
    "ukbb.engine.wait": "ukbb.stage.aortic",
    "ukbb.deploy.write": "ukbb.stage.aortic",
    "ukbb.phenotype.aortic_areas": "ukbb.stage.aortic",
    "ukbb.phenotype.aortic_qc": "ukbb.phenotype.aortic_areas",
    "ukbb.phenotype.aortic_qc.batch": "ukbb.phenotype.aortic_qc",
}
# where the file spans open, by the innermost span around them
SA_IO = {
    "ukbb.io.nifti.load": {"ukbb.stage.segment", "ukbb.phenotype.qc",
                           "ukbb.phenotype.wall_thickness",
                           "ukbb.phenotype.strain.crop",
                           "ukbb.phenotype.strain.contours"},
    "ukbb.io.nifti.save": {"ukbb.deploy.write"},
    "ukbb.io.vtk": {"ukbb.phenotype.wall_thickness",
                    "ukbb.phenotype.strain.contours"},
    "ukbb.io.csv": {"ukbb.phenotype.wall_thickness",
                    "ukbb.phenotype.strain.tables",
                    "ukbb.stage.wall_thickness", "ukbb.stage.strain"},
}
AO_IO = {
    "ukbb.io.nifti.load": {"ukbb.stage.aortic",
                           "ukbb.phenotype.aortic_areas"},
    "ukbb.io.nifti.save": {"ukbb.deploy.write"},
}


def _spans(prof):
    """(name, start_us, end_us, thread) of every event the profiler kept
    whose name is a span of the port or the test's capture marker."""
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events()
            if e.name.startswith("ukbb.") or e.name == CAPTURED]


def _innermost_around(spans, s):
    """The shortest span of the vocabulary that holds span ``s`` on its
    thread (not ``s`` itself), or None."""
    name, a, b, th = s
    outer = [x for x in spans if x is not s and x[3] == th
             and x[0].startswith("ukbb.") and x[1] <= a and b <= x[2]
             and (x[2] - x[1]) >= (b - a)]
    return min(outer, key=lambda x: x[2] - x[1])[0] if outer else None


def _mark_captured(monkeypatch):
    """Run every function a program captures inside a ``test.captured``
    range (on the CPU the cache runs it as it is, at every call)."""
    run = programs.ProgramCache.run

    def marked(self, tag, fn, *inputs, out=None):
        def captured(*xs):
            with torch.profiler.record_function(CAPTURED):
                return fn(*xs)
        return run(self, tag, captured, *inputs, out=out)

    monkeypatch.setattr(programs.ProgramCache, "run", marked)


@pytest.fixture(scope="module")
def sa_run(tmp_path_factory):
    """One phantom subject (96^2, Z 8, T 6) through the SA cohort with the
    trained FCN, segmented again, under the profiler."""
    root = tmp_path_factory.mktemp("spans_sa")
    write_full_subject(str(root / "1000001"), 0, with_seg=False)
    engine = InferenceEngine(load_segmentation_model(SA_BUNDLE, "cpu"))
    with pytest.MonkeyPatch.context() as mp:
        _mark_captured(mp)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            res = run_cohort_sa(str(root), engine, device="cpu",
                                skip_existing_seg=False, verbose=False)
    assert res.fleet.succeeded == ["1000001"], res.fleet.failed
    assert "1000001" in res.strain_rows
    return res, _spans(prof)


@pytest.fixture(scope="module")
def ao_run(tmp_path_factory):
    """One aortic phantom subject through ``run_cohort_full`` with the
    aortic engine alone, under the profiler."""
    root = tmp_path_factory.mktemp("spans_ao")
    _ao_only_subject(str(root), "1000001")
    engine = load_aortic_engine(AO_BUNDLE, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        _mark_captured(mp)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            res = run_cohort_full(str(root), {"ao": engine},
                                  pressure={1000001: 40.0}, device="cpu",
                                  skip_existing_seg=False, verbose=False)
    assert res.fleet.succeeded == ["1000001"], res.fleet.failed
    return res, _spans(prof)


def _check_vocabulary(spans, parents, io):
    names = {s[0] for s in spans}
    assert set(parents) | set(io) | {"ukbb.subject"} <= names
    assert sum(s[0] == "ukbb.subject" for s in spans) == 1
    assert _innermost_around(spans, next(
        s for s in spans if s[0] == "ukbb.subject")) is None
    for s in spans:
        if s[0] in parents:
            assert _innermost_around(spans, s) == parents[s[0]], s
        elif s[0] in io:
            assert _innermost_around(spans, s) in io[s[0]], s
    # every span of the port lies in the subject; on the CPU no program
    # captures, so the program spans never open
    assert all(_innermost_around(spans, s) is not None for s in spans
               if s[0].startswith("ukbb.") and s[0] != "ukbb.subject")
    assert not any(n.startswith("ukbb.program.") for n in names)


def test_sa_cohort_spans_nest_as_documented(sa_run):
    _check_vocabulary(sa_run[1], SA_PARENTS, SA_IO)


def test_aortic_cohort_spans_nest_as_documented(ao_run):
    _check_vocabulary(ao_run[1], AO_PARENTS, AO_IO)


def test_every_aortic_qc_holds_one_batch_pass(ao_run):
    """The single-slice aortic cine takes the gate's one pass over its
    frames: one ``.aortic_qc.batch`` span inside each ``.aortic_qc``."""
    spans = ao_run[1]
    gates = [s for s in spans if s[0] == "ukbb.phenotype.aortic_qc"]
    batches = [s for s in spans if s[0] == "ukbb.phenotype.aortic_qc.batch"]
    assert len(gates) == len(batches) == 1
    for _, a, b, th in gates:
        assert sum(x[3] == th and a <= x[1] and x[2] <= b
                   for x in batches) == 1


@pytest.mark.parametrize("Z", [1, 2])
def test_aortic_qc_batch_span_marks_the_route(Z):
    """A cine of one slice opens the batch span, one of two slices (the
    per-frame route) does not; both gates pass."""
    X, Y, T = 40, 36, 5
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    seg = np.zeros((X, Y, Z, T), np.int16)
    seg[(xx - 12) ** 2 + (yy - 18) ** 2 <= 36] = 1
    seg[(xx - 28) ** 2 + (yy - 18) ** 2 <= 25] = 2
    image = np.where(seg > 0, 900.0, 40.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert aorta_pass_quality_control(image, seg) is True
    names = [s[0] for s in _spans(prof)]
    assert names.count("ukbb.phenotype.aortic_qc") == 1
    assert names.count("ukbb.phenotype.aortic_qc.batch") == (Z == 1)


@pytest.mark.parametrize("which", ["sa", "ao"])
def test_stage_spans_last_their_stage_seconds(which, sa_run, ao_run):
    res, spans = sa_run if which == "sa" else ao_run
    (stages,) = res.stage_seconds.values()
    got = {s[0][len("ukbb.stage."):]: (s[2] - s[1]) * 1e-6 for s in spans
           if s[0].startswith("ukbb.stage.")}
    assert set(got) == set(stages)
    for key, seconds in stages.items():
        assert abs(got[key] - seconds) <= 0.005 + 0.05 * seconds, key


@pytest.mark.parametrize("which", ["sa", "ao"])
def test_no_span_opens_inside_a_captured_function(which, sa_run, ao_run):
    spans = (sa_run if which == "sa" else ao_run)[1]
    captured = [s for s in spans if s[0] == CAPTURED]
    # the engine's prep, chunk forward and pack (and the registration's
    # and strain stage's programs in SA) ran through the cache
    assert len(captured) >= 3
    for name, a, b, th in spans:
        if name.startswith("ukbb."):
            assert not any(c[3] == th and c[1] <= a and b <= c[2]
                           for c in captured), name


@pytest.mark.parametrize("which", ["sa", "ao"])
def test_cohort_saves_reorder_no_voxels(which, sa_run, ao_run):
    """Every NIfTI the cohort writes (the SA seg cine, its ED/ES frames
    and the ED/ES image frames; the aortic seg) is Fortran-contiguous
    already: no save opens ``ukbb.io.nifti.reorder``."""
    names = [s[0] for s in (sa_run if which == "sa" else ao_run)[1]]
    assert names.count("ukbb.io.nifti.save") >= (5 if which == "sa" else 1)
    assert "ukbb.io.nifti.reorder" not in names


def test_save_of_a_strided_view_reorders_once(tmp_path):
    """A C-ordered cine and a frame of it, saved: one reorder span inside
    each save; its Fortran-ordered copy, saved: none, and the same
    bytes."""
    cine = np.random.RandomState(0).randint(0, 4, (12, 10, 3, 5)).astype(
        np.int16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        nifti.save(nifti.Nifti1Image(cine, None), str(tmp_path / "c.nii.gz"))
        nifti.save(nifti.Nifti1Image(cine[:, :, :, 2], None),
                   str(tmp_path / "c2.nii.gz"))
    spans = _spans(prof)
    reorders = [s for s in spans if s[0] == "ukbb.io.nifti.reorder"]
    assert len(reorders) == 2
    assert all(_innermost_around(spans, s) == "ukbb.io.nifti.save"
               for s in reorders)
    fortran = np.asfortranarray(cine)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        nifti.save(nifti.Nifti1Image(fortran, None),
                   str(tmp_path / "f.nii.gz"))
        nifti.save(nifti.Nifti1Image(fortran[:, :, :, 2], None),
                   str(tmp_path / "f2.nii.gz"))
    names = [s[0] for s in _spans(prof)]
    assert names.count("ukbb.io.nifti.save") == 2
    assert "ukbb.io.nifti.reorder" not in names
    for c, f in (("c", "f"), ("c2", "f2")):
        assert ((tmp_path / f"{c}.nii.gz").read_bytes()
                == (tmp_path / f"{f}.nii.gz").read_bytes())


def test_span_without_a_profiler_never_calls_record_function(
        tmp_path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not timing._recording()

    @span("ukbb.test.decorated")
    def twice(x):
        """Doubles."""
        return 2 * x

    with span("ukbb.test.block") as s:
        assert s.name == "ukbb.test.block"
    assert twice(21) == 42 and twice.__doc__ == "Doubles."
    timer = StageTimer()
    with timer.span("stage"):
        pass
    assert timer.summary()["stage"]["count"] == 1
    # a decorated function of the program, on its path
    path = str(tmp_path / "x.nii.gz")
    nifti.save(nifti.Nifti1Image(np.zeros((4, 4, 2), np.int16), None), path)
    assert nifti.load(path).shape == (4, 4, 2)


def test_span_under_a_profiler_opens_one_range_per_use():
    @span("ukbb.test.decorated")
    def work():
        torch.ones(4).sum()

    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("ukbb.test.block"):
            work()
        work()
        with timer.span("stage"):
            with timer.span("inner"):
                pass
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread)
             for e in prof.events()]
    count = {n: sum(s[0] == n for s in spans) for n in
             ("ukbb.test.block", "ukbb.test.decorated", "stage", "inner")}
    assert count == {"ukbb.test.block": 1, "ukbb.test.decorated": 2,
                     "stage": 1, "inner": 1}
    block = next(s for s in spans if s[0] == "ukbb.test.block")
    first = min((s for s in spans if s[0] == "ukbb.test.decorated"),
                key=lambda s: s[1])
    assert block[1] <= first[1] and first[2] <= block[2]
    assert sorted(timer.summary()) == ["stage", "stage/inner"]


def test_run_cohort_trace_dir_writes_the_spans(tmp_path):
    data = tmp_path / "data"
    _ao_only_subject(str(data), "1000001")
    trace_dir = tmp_path / "trace"
    rc = run_cohort.main(["--data_dir", str(data), "--model_path",
                          SA_BUNDLE, "--model_path_ao", AO_BUNDLE,
                          "--output_dir", str(tmp_path / "csv"),
                          "--device", "cpu", "--force",
                          "--trace_dir", str(trace_dir)])
    assert rc == 0
    (path,) = glob.glob(str(trace_dir / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ukbb.subject", "ukbb.stage.aortic", "ukbb.engine.dispatch",
            "ukbb.engine.wait", "ukbb.io.nifti.save", "ukbb.io.csv",
            "ukbb.phenotype.aortic_areas"} <= names
