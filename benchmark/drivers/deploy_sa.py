"""The SA deploy of a TransUNet bundle: ``infer/deploy.py::
deploy_subject_sequence(engine, dir, "sa")`` over phantom subjects, one
worker, one subject at a time, each pass a fresh subject directory (so
the deploy's skip rule never fires and every subject is segmented
again): read, the engine's graphs on the model's fixed grid, ``seg_sa``
and its ED/ES frames written.  The bundle is written at set-up from the
seed (``reference/transunet_sa.py::write_bundle``) into the run's work
directory and loaded through ``load_segmentation_model``.

The reference (``reference/transunet_sa.py``) judges the labels of every
pass in the window of a seeded sample of phantoms, one of each shape,
and the softmax probabilities of the sample's first phantom: a fresh
engine (the window's is released before the check) gives the program's
with ``want_prob`` on the reference's rescaled cine."""

from __future__ import annotations

import os
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness.cohort import Cohort, Pass, closed_loop
from benchmark.reference import compare, transunet_sa
from benchmark.reference.port.io import nifti

P = "ukbb_cardiac_tpu_torch."
SPANS = [(P + "infer.deploy", "_start_subject_sequence", "segment.read+queue"),
         (P + "infer.deploy", "_finish_subject_sequence",
          "segment.wait+write"),
         (P + "io.nifti", "save", "nifti.save"),
         (P + "io.nifti", "load", "nifti.load")]


def _dtype(ctx):
    cfg = ctx.config
    name = cfg["low_precision"]["compute_dtype"] if ctx.low_precision \
        else cfg["compute_dtype"]
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def bundle(ctx) -> str:
    """The run's bundle, written from its seed at the first call."""
    path = os.path.join(ctx.workdir, "transunet_sa.npz")
    if not os.path.exists(path):
        transunet_sa.write_bundle(path, ctx.config, ctx.seed,
                                  ctx.traffic["geometry"], ctx.device)
    return path


def _engine(ctx):
    from ukbb_cardiac_tpu_torch.infer.deploy import load_segmentation_model
    from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
    return InferenceEngine(load_segmentation_model(bundle(ctx), ctx.device,
                                                   _dtype(ctx)),
                           chunk=ctx.config["chunk"])


def setup(ctx):
    t0 = time.perf_counter()
    cohort = Cohort(ctx.traffic, ctx.seed, ctx.workdir)
    cohort.write_inputs()
    print(f"set-up: inputs written in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    bundle(ctx)
    print(f"set-up: bundle written in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    st = SimpleNamespace(ctx=ctx, cohort=cohort, engine=_engine(ctx))
    print(f"set-up: bundle loaded in {time.perf_counter() - t0:.3f} s")
    # a subject of each shape: the prep and pack programs are per cine
    # shape; the chunk forward is one, on the model's grid
    for name, p, d in cohort.warm_dirs():
        t0 = time.perf_counter()
        ps = _process(st, name, p, d)
        if not ps.ok:
            raise RuntimeError(f"warm-up subject failed:\n{ps.error}")
        print(f"set-up: warm-up of {cohort.phantoms[p]} in "
              f"{time.perf_counter() - t0:.3f} s")
    return st


def _process(st, name, p, d) -> Pass:
    from ukbb_cardiac_tpu_torch.infer.deploy import deploy_subject_sequence
    t0 = time.perf_counter()
    try:
        deploy_subject_sequence(st.engine, d, "sa")
        ok, error = True, None
    except Exception:  # a subject that raises counts as failed
        ok, error = False, traceback.format_exc()
    return Pass(k=-1, name=name, phantom=p, ok=ok, error=error,
                stages={"deploy": time.perf_counter() - t0}, t_end=0.0,
                outputs={"shape": st.cohort.phantoms[p]})


def window(st, seconds: float) -> dict:
    before = {repr(p.key) for p in st.engine.programs()}
    held = {id(p) for p in st.engine.programs()}
    passes = closed_loop(st.cohort, seconds,
                         lambda name, p, d: _process(st, name, p, d))
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
    """The reference's labels and probabilities for phantom ``p``
    (``precision`` ``tf32``: the control's)."""
    cine = np.asarray(nifti.load(cohort.input_path(p)).dataobj)
    return transunet_sa.reference_subject(
        cine, ctx.config, bundle(ctx), ctx.device, precision,
        want_prob=True)


def program_prob(st, p: int) -> np.ndarray:
    """The program's softmax probabilities (X, Y, Z, T, n_class) of
    phantom ``p``: a fresh engine's ``want_prob`` path on the reference's
    rescaled cine."""
    cine = np.asarray(nifti.load(st.cohort.input_path(p)).dataobj)
    x = transunet_sa.rescaled(cine, st.ctx.device).cpu().numpy()
    engine = _engine(st.ctx)
    try:
        return engine.segment_sequence(x, want_prob=True)[1]
    finally:
        engine.release_programs()


def numbers(pairs) -> dict:
    """Each number over (got, reference) pairs; infinity when there was
    nothing to compare.

    - ``label_mismatch``: the share of voxels whose label differs, over
      every compared subject (``label_mismatch_max``: the worst subject);
    - ``prob_max_abs``: the largest gap between the softmax
      probabilities, over the pairs that hold them;
    - ``label_majority_share``: the largest class's share of the
      reference's labels, the worst subject (a constant argmax reads
      1)."""
    out = {"label_mismatch": compare.mean_label_mismatch(
        [(got["labels"], ref["labels"]) for got, ref in pairs]),
        "prob_max_abs": float("inf"), "label_majority_share": 0.0,
        "label_mismatch_max": 0.0}
    probs = [abs(got["prob"] - ref["prob"]).max() for got, ref in pairs
             if "prob" in got and "prob" in ref]
    if probs:
        out["prob_max_abs"] = float(max(probs))
    for ref in {id(ref): ref for _, ref in pairs}.values():
        counts = np.bincount(np.asarray(ref["labels"]).reshape(-1))
        out["label_majority_share"] = max(out["label_majority_share"],
                                          float(counts.max() / counts.sum()))
    for got, ref in pairs:
        out["label_mismatch_max"] = max(
            out["label_mismatch_max"],
            compare.label_mismatch(got["labels"], ref["labels"]))
    if not pairs:
        out = {k: float("inf") for k in out}
    return out


def check(st, record) -> dict:
    sample = st.cohort.sample(record["passes"], st.ctx.seed)
    prob = {p: program_prob(st, p) for p in sample[:1]}
    pairs = []
    for p in sample:
        ref = reference(st.ctx, st.cohort, p)
        for ps in record["passes"]:
            if ps.phantom == p and ps.ok:
                got = {"labels": np.asarray(nifti.load(os.path.join(
                    st.cohort.root, ps.name, "seg_sa.nii.gz")).dataobj)}
                if p in prob:
                    got["prob"] = prob.pop(p)   # once: the engine's
                pairs.append((got, ref))
    return numbers(pairs)
