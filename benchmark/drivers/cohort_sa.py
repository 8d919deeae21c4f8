"""The SA cohort: ``parallel/cohort.py::run_cohort_sa`` over phantom
subjects, one worker, one subject at a time, every subject segmented
again (``skip_existing_seg=False``): segmentation, volumes, wall
thickness and strain.  The reference (``reference/fcn_sa.py``) judges the
labels, the volume row and the strain tables of every pass in the window
of a seeded sample of phantoms, one of each shape."""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.counts.cohort_work import strain_image
from benchmark.harness.cohort import Cohort, Pass, closed_loop
from benchmark.reference import compare, fcn_sa
from benchmark.reference.port.io import nifti
from benchmark.reference.stages import volume_row

P = "ukbb_cardiac_tpu_torch."
SPANS = [(P + "infer.deploy", "_start_subject_sequence", "segment.read+queue"),
         (P + "infer.deploy", "_finish_subject_sequence",
          "segment.wait+write"),
         (P + "phenotype.ventricle", "ventricular_volume_measures_from_seg",
          "volumes"),
         (P + "phenotype.qc", "sa_pass_quality_control", "qc"),
         (P + "phenotype.wall_thickness", "evaluate_wall_thickness",
          "wall_thickness"),
         (P + "phenotype.strain", "start_sa_motion_dispatch",
          "strain.contours+queue"),
         (P + "phenotype.strain", "finish_sa_motion", "strain.wait+tables"),
         (P + "io.nifti", "save", "nifti.save"),
         (P + "io.nifti", "load", "nifti.load")]


def _dtype(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def setup(ctx):
    from ukbb_cardiac_tpu_torch.infer.deploy import load_segmentation_model
    from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
    from ukbb_cardiac_tpu_torch.reg.register import RegConfig

    cfg = ctx.config
    dtype = cfg["low_precision"]["compute_dtype"] if ctx.low_precision \
        else cfg["compute_dtype"]
    t0 = time.perf_counter()
    cohort = Cohort(ctx.traffic, ctx.seed, ctx.workdir)
    cohort.write_inputs()
    print(f"set-up: inputs written in {time.perf_counter() - t0:.3f} s")
    engine = InferenceEngine(
        load_segmentation_model(cfg["bundle"], ctx.device, _dtype(dtype)),
        chunk=cfg["chunk"])
    st = SimpleNamespace(ctx=ctx, cohort=cohort, engine=engine,
                         reg=RegConfig(**cfg["registration"]))
    # the whole chain on a subject of each shape: the engine's programs
    # are per cine shape, the strain stage's per crop, and the crop
    # follows the labels
    for name, p, _ in cohort.warm_dirs():
        t0 = time.perf_counter()
        ps = _process(st, cohort.warm_root, name, p)
        if not ps.ok:
            raise RuntimeError(f"warm-up subject failed:\n{ps.error}")
        print(f"set-up: warm-up of {cohort.phantoms[p]} in "
              f"{time.perf_counter() - t0:.3f} s")
    return st


def _process(st, root, name, p) -> Pass:
    from ukbb_cardiac_tpu_torch.parallel.cohort import run_cohort_sa

    res = run_cohort_sa(root, st.engine, subjects=[name],
                        workers=st.ctx.traffic["workers"], cfg=st.reg,
                        skip_existing_seg=False, verbose=False,
                        device=st.ctx.device)
    return Pass(k=-1, name=name, phantom=p, ok=name in res.fleet.succeeded,
                error=res.fleet.failed.get(name),
                stages=res.stage_seconds.get(name, {}), t_end=0.0,
                outputs={"volumes": res.volume_rows.get(name),
                         "shape": st.cohort.phantoms[p]})


def program_keys(st) -> set:
    """The keys of the programs the program holds: the registration's
    and the strain stage's, and the engine's."""
    from ukbb_cardiac_tpu_torch.reg import programs
    return {repr(p.key) for p in programs.programs() + st.engine.programs()}


def program_ids(st) -> set:
    """The identities of the programs held: a program dropped by a cache
    bound and captured again is a new one."""
    from ukbb_cardiac_tpu_torch.reg import programs
    return {id(p) for p in programs.programs() + st.engine.programs()}


def window(st, seconds: float) -> dict:
    before, held = program_keys(st), program_ids(st)
    passes = closed_loop(st.cohort, seconds, lambda name, p, d: _process(
        st, st.cohort.root, name, p))
    new = sorted(program_keys(st) - before)
    return {"passes": passes, "attempted": len(passes),
            "failed": sum(not ps.ok for ps in passes),
            "window_s": passes[-1].t_end, "programs_added": len(new),
            "programs_captured": len(program_ids(st) - held),
            "new_programs": new}


def release(st) -> None:
    from ukbb_cardiac_tpu_torch.reg import programs
    st.engine.release_programs()
    programs.clear()
    st.engine = None
    if st.ctx.device != "cpu":
        torch.cuda.empty_cache()


def reference(ctx, cohort, p: int, precision: str = "float32") -> dict:
    """The reference's outputs for phantom ``p`` (``precision`` ``tf32``:
    the control's)."""
    return fcn_sa.reference_subject(
        cohort.input_path(p), ctx.config, ctx.device,
        os.path.join(ctx.workdir, "reference", f"{p:02d}-{precision}"),
        precision)


def program_outputs(st, ps: Pass) -> dict:
    """What the program wrote for one pass, as the reference's dict, and
    the volume row that the reference's volume stage gives for the
    program's own labels."""
    d = os.path.join(st.cohort.root, ps.name)
    labels = np.asarray(nifti.load(os.path.join(d, "seg_sa.nii.gz")).dataobj)
    header = nifti.load(st.cohort.input_path(ps.phantom)).header
    return {"labels": labels, "volumes": ps.outputs["volumes"],
            "stage_volumes": volume_row(labels, header),
            "strain": fcn_sa.read_strain(os.path.join(d, "strain_sa"))}


def numbers(pairs) -> dict:
    """Each number over (got, reference) pairs; infinity when there was
    nothing to compare.

    - ``label_mismatch``: the share of voxels whose label differs, over
      every compared subject (``label_mismatch_max``: the worst subject);
    - ``volume_stage_rel``: the volume row against the reference's volume
      stage on the same labels, the stage judged by itself (exact);
    - ``strain_mean_pp``: the mean gap over every entry of the strain
      tables (``strain_pp``, ``strain_global_pp``, ``strain_summary_pp``:
      worst entries of the tables, of their Global rows and of the
      cohort's row of peaks);
    - ``volume_rel``: the volume row against the reference's."""
    out = {"label_mismatch": 0.0, "volume_stage_rel": 0.0,
           "strain_mean_pp": 0.0, "label_mismatch_max": 0.0,
           "volume_rel": 0.0, "strain_pp": 0.0, "strain_global_pp": 0.0,
           "strain_summary_pp": 0.0}
    for got, ref in pairs:
        out["label_mismatch_max"] = max(
            out["label_mismatch_max"],
            compare.label_mismatch(got["labels"], ref["labels"]))
        out["volume_stage_rel"] = max(out["volume_stage_rel"],
                                      compare.relative_gap(
                                          got["volumes"],
                                          got["stage_volumes"]))
        out["volume_rel"] = max(out["volume_rel"], compare.relative_gap(
            got["volumes"], ref["volumes"]))
        out["strain_pp"] = max(out["strain_pp"], compare.table_gap(
            got["strain"], ref["strain"]))
        out["strain_global_pp"] = max(out["strain_global_pp"],
                                      compare.table_gap(
                                          compare.global_rows(got["strain"]),
                                          compare.global_rows(ref["strain"])))
        out["strain_summary_pp"] = max(
            out["strain_summary_pp"], compare.table_gap(
                compare.strain_summary(got["strain"]),
                compare.strain_summary(ref["strain"])))
    out["label_mismatch"] = compare.mean_label_mismatch(
        [(got["labels"], ref["labels"]) for got, ref in pairs])
    out["strain_mean_pp"] = compare.mean_table_gap(
        [(got["strain"], ref["strain"]) for got, ref in pairs])
    if not pairs:
        out = {k: float("inf") for k in out}
    return out


def check(st, record) -> dict:
    for ps in record["passes"]:
        # the registration's image, for the B-spline count: the crop the
        # strain stage took from the ED labels this pass wrote
        ed = os.path.join(st.cohort.root, ps.name, "seg_sa_ED.nii.gz")
        if ps.ok and os.path.exists(ed):
            ps.outputs["strain_image"] = strain_image(
                np.asarray(nifti.load(ed).dataobj))
    pairs = []
    for p in st.cohort.sample(record["passes"], st.ctx.seed):
        ref = reference(st.ctx, st.cohort, p)
        pairs += [(program_outputs(st, ps), ref) for ps in record["passes"]
                  if ps.phantom == p and ps.ok]
    return numbers(pairs)
