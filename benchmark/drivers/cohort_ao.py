"""The aortic stage of the cohort: ``parallel/cohort.py::run_cohort_full``
with only the aortic engine, over phantom aortic cines, one worker, one
subject at a time, every subject segmented again
(``skip_existing_seg=False``): the deploy (U-Net and ConvLSTM in one
graph), then the areas and distensibility from a seeded pulse-pressure
table.  The reference (``reference/unet_lstm_ao.py``) judges the labels
and the area row of every pass in the window of a seeded sample of
phantoms."""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness.cohort import Cohort, Pass, closed_loop
from benchmark.reference import compare, unet_lstm_ao
from benchmark.reference.port.io import nifti
from benchmark.reference.stages import area_row

P = "ukbb_cardiac_tpu_torch."
SPANS = [(P + "infer.deploy_ao", "_start_subject_ao", "aortic.read+queue"),
         (P + "infer.deploy_ao", "_finish_subject_ao", "aortic.wait+write"),
         (P + "phenotype.aorta", "aorta_pass_quality_control", "aortic.qc"),
         (P + "phenotype.aorta", "aortic_area_measures", "aortic.areas"),
         (P + "phenotype.atrium", "atrial_volume_measures",
          "atrial_volumes"),
         (P + "io.nifti", "save", "nifti.save"),
         (P + "io.nifti", "load", "nifti.load")]


def setup(ctx):
    from ukbb_cardiac_tpu_torch.infer.deploy_ao import load_aortic_engine

    cfg = ctx.config
    dtype = cfg["low_precision"]["compute_dtype"] if ctx.low_precision \
        else cfg["compute_dtype"]
    t0 = time.perf_counter()
    cohort = Cohort(ctx.traffic, ctx.seed, ctx.workdir)
    cohort.write_inputs()
    print(f"set-up: inputs written in {time.perf_counter() - t0:.3f} s")
    engine = load_aortic_engine(cfg["bundle"], ctx.device,
                                {"float32": torch.float32,
                                 "bfloat16": torch.bfloat16}[dtype])
    st = SimpleNamespace(ctx=ctx, cohort=cohort, engine=engine)
    for name, p, _ in cohort.warm_dirs():
        t0 = time.perf_counter()
        ps = _process(st, cohort.warm_root, name, p)
        if not ps.ok:
            raise RuntimeError(f"warm-up subject failed:\n{ps.error}")
        print(f"set-up: warm-up of {cohort.phantoms[p]} in "
              f"{time.perf_counter() - t0:.3f} s")
    return st


def _process(st, root, name, p) -> Pass:
    from ukbb_cardiac_tpu_torch.parallel.cohort import run_cohort_full

    res = run_cohort_full(root, {"ao": st.engine}, subjects=[name],
                          workers=st.ctx.traffic["workers"],
                          pressure=st.cohort.pressure_of({name: p}),
                          skip_existing_seg=False, verbose=False,
                          device=st.ctx.device)
    row = res.aortic_rows.get(name)
    return Pass(k=-1, name=name, phantom=p, ok=name in res.fleet.succeeded,
                error=res.fleet.failed.get(name),
                stages=res.stage_seconds.get(name, {}), t_end=0.0,
                outputs={"areas": None if row is None
                         else dict(zip(unet_lstm_ao.AREA_KEYS, row)),
                         "shape": st.cohort.phantoms[p]})


def window(st, seconds: float) -> dict:
    before = {repr(p.key) for p in st.engine.programs()}
    held = {id(p) for p in st.engine.programs()}
    passes = closed_loop(st.cohort, seconds, lambda name, p, d: _process(
        st, st.cohort.root, name, p))
    new = sorted({repr(p.key) for p in st.engine.programs()} - before)
    return {"passes": passes, "attempted": len(passes),
            "failed": sum(not ps.ok for ps in passes),
            "window_s": passes[-1].t_end, "programs_added": len(new),
            "programs_captured": len({id(p) for p in st.engine.programs()}
                                     - held),
            "new_programs": new}


def release(st) -> None:
    st.engine.release_programs()
    st.engine = None
    if st.ctx.device != "cpu":
        torch.cuda.empty_cache()


def reference(ctx, cohort, p: int, precision: str = "float32") -> dict:
    """The reference's outputs for phantom ``p`` (``precision`` ``tf32``:
    the control's)."""
    return unet_lstm_ao.reference_subject(
        cohort.input_path(p), ctx.config, ctx.device,
        os.path.join(ctx.workdir, "reference", f"{p:02d}-{precision}"),
        float(cohort.pressures[p]), precision)


def program_outputs(st, ps: Pass) -> dict:
    """What the program wrote for one pass, as the reference's dict, and
    the area row that the reference's area stage gives for the program's
    own labels and the subject's pulse pressure."""
    d = os.path.join(st.cohort.root, ps.name)
    labels = np.asarray(nifti.load(os.path.join(d, "seg_ao.nii.gz")).dataobj)
    cine = nifti.load(st.cohort.input_path(ps.phantom))
    return {"labels": labels.astype(np.int32),
            "areas": ps.outputs["areas"],
            "stage_areas": area_row(np.asarray(cine.dataobj), labels,
                                    cine.header,
                                    float(st.cohort.pressures[ps.phantom]))}


def numbers(pairs) -> dict:
    """Each number over (got, reference) pairs; infinity when there was
    nothing to compare.

    - ``label_mismatch``: the share of voxels whose label differs, over
      every compared subject (``label_mismatch_max``: the worst subject);
    - ``area_stage_rel``: the area row against the reference's area stage
      on the same labels, the stage judged by itself (exact);
    - ``area_rel``: the area row against the reference's."""
    out = {"label_mismatch": 0.0, "area_stage_rel": 0.0,
           "label_mismatch_max": 0.0, "area_rel": 0.0}
    for got, ref in pairs:
        out["label_mismatch_max"] = max(
            out["label_mismatch_max"],
            compare.label_mismatch(got["labels"], ref["labels"]))
        out["area_stage_rel"] = max(out["area_stage_rel"],
                                    compare.relative_gap(got["areas"],
                                                         got["stage_areas"]))
        out["area_rel"] = max(out["area_rel"], compare.relative_gap(
            got["areas"], ref["areas"]))
    out["label_mismatch"] = compare.mean_label_mismatch(
        [(got["labels"], ref["labels"]) for got, ref in pairs])
    if not pairs:
        out = {k: float("inf") for k in out}
    return out


def check(st, record) -> dict:
    pairs = []
    for p in st.cohort.sample(record["passes"], st.ctx.seed):
        ref = reference(st.ctx, st.cohort, p)
        pairs += [(program_outputs(st, ps), ref) for ps in record["passes"]
                  if ps.phantom == p and ps.ok]
    return numbers(pairs)
