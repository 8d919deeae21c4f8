"""Cohort driver: whole subjects end to end over a worker pool.

Counterpart of ``ukbb_cardiac_tpu/parallel/cohort.py``.  Each subject runs
the SA chain

    segmentation → volumes → wall thickness → strain motion tracking

and, in full mode, the long-axis chain and the aortic stage after it

    LA deploys (la_2ch, la_4ch, la_4ch seg4) → atrial volumes → LA strain
    → aortic deploy → aortic areas

with subjects processed by a thread pool (``parallel/fleet.py``), one
worker by default: the count every benchmark cell runs (PERF.md section
4); more workers have no cell yet (ROADMAP.md C2, F1).  Every worker
issues its work on the default stream.  The per-subject
files and the aggregate CSVs are the reference CLIs'.

Each subject runs inside the profiler span ``ukbb.subject`` and each
stage inside ``ukbb.stage.<key>``, the stretch that
``stage_seconds[<key>]`` times on the host clock (``utils/timing.py``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from typing import Dict, Optional, Sequence

import pandas as pd

from ukbb_cardiac_tpu_torch.parallel.fleet import FleetResult, run_fleet
from ukbb_cardiac_tpu_torch.parallel.mesh import resolve_device_for
from ukbb_cardiac_tpu_torch.utils.timing import span


class CohortResult:
    def __init__(self):
        self.fleet: Optional[FleetResult] = None
        self.volume_rows: Dict[str, dict] = {}
        self.wt_rows: Dict[str, list] = {}
        self.wt_max_rows: Dict[str, list] = {}
        self.strain_rows: Dict[str, list] = {}
        self.atrial_rows: Dict[str, dict] = {}
        self.la_strain_rows: Dict[str, list] = {}
        self.aortic_rows: Dict[str, list] = {}
        self.stage_seconds: Dict[str, Dict[str, float]] = {}
        self.wall_seconds: float = 0.0

    @property
    def subjects_per_s(self) -> float:
        n = len(self.fleet.succeeded) if self.fleet else 0
        return n / self.wall_seconds if self.wall_seconds > 0 else 0.0


@contextlib.contextmanager
def _stage(stages: Dict[str, float], key: str):
    """Time the block into ``stages[key]`` (host wall clock; a stage that
    raises records nothing) inside the span ``ukbb.stage.<key>``."""
    t0 = time.time()
    with span("ukbb.stage." + key):
        yield
    stages[key] = time.time() - t0


def _read_csv(path: str, **kwargs) -> pd.DataFrame:
    with span("ukbb.io.csv"):
        return pd.read_csv(path, **kwargs)


def process_subject_sa(engine, data_dir: str,
                       cfg=None, register_batch=None, mesh=None,
                       eval_dice: bool = False,
                       result: Optional[CohortResult] = None,
                       skip_existing_seg: bool = True,
                       device=None) -> Dict[str, float]:
    """The full SA chain for one subject directory; returns stage seconds.

    ``engine`` is the shared :class:`InferenceEngine`.  The strain stage
    runs on ``device`` (default the card; ``"cpu"`` when asked; with a
    ``mesh``, its first device) with registration config ``cfg`` (default
    ``RegConfig()``), a prebuilt ``register_batch`` if given, and its pair
    population split over ``mesh`` if given.
    """
    from ukbb_cardiac_tpu_torch.infer.deploy import (_finish_subject_sequence,
                                                     _start_subject_sequence)
    from ukbb_cardiac_tpu_torch.phenotype.qc import sa_pass_quality_control
    from ukbb_cardiac_tpu_torch.phenotype.strain import (
        finish_sa_motion, start_sa_motion_dispatch)
    from ukbb_cardiac_tpu_torch.phenotype.ventricle import (
        ventricular_volume_measures, ventricular_volume_measures_from_seg)
    from ukbb_cardiac_tpu_torch.phenotype.wall_thickness import \
        evaluate_wall_thickness

    subject = os.path.basename(data_dir.rstrip("/"))
    stages: Dict[str, float] = {}

    # --- 1. segmentation (deploy_network.py semantics) --------------------
    with _stage(stages, "segment"):
        seg_name = os.path.join(data_dir, "seg_sa.nii.gz")
        pred_mem = header_mem = None
        if not (skip_existing_seg and os.path.exists(seg_name)):
            ctx = _start_subject_sequence(engine, data_dir, "sa", seg4=False,
                                          force=not skip_existing_seg)
            if ctx is not None:
                _finish_subject_sequence(ctx, "sa", seg4=False,
                                         save_seg=True)
                pred_mem = ctx.get("pred")
                header_mem = ctx["nim"].header

    # --- 2. ventricular volumes (eval_ventricular_volume.py) --------------
    with _stage(stages, "volumes"):
        if pred_mem is not None:
            # the seg is still in memory: files are outputs, not
            # inter-stage IPC
            vol_row = ventricular_volume_measures_from_seg(pred_mem,
                                                           header_mem)
        else:
            vol_row = ventricular_volume_measures(
                os.path.join(data_dir, "sa.nii.gz"), seg_name)

    # --- 3. wall thickness (eval_wall_thickness.py, QC-gated) -------------
    with _stage(stages, "wall_thickness"):
        wt_row = wt_max_row = None
        seg_ed = os.path.join(data_dir, "seg_sa_ED.nii.gz")
        qc_ok = os.path.exists(seg_ed) and sa_pass_quality_control(seg_ed)
        if qc_ok:
            evaluate_wall_thickness(
                seg_ed, os.path.join(data_dir, "wall_thickness_ED"))
            mean_csv = os.path.join(data_dir, "wall_thickness_ED.csv")
            max_csv = os.path.join(data_dir, "wall_thickness_ED_max.csv")
            if os.path.exists(mean_csv):
                wt_row = list(_read_csv(mean_csv,
                                        index_col=0)["Thickness"].values)
            if os.path.exists(max_csv):
                wt_max_row = list(_read_csv(
                    max_csv, index_col=0)["Thickness_Max"].values)

    # --- 4. strain motion tracking (eval_strain_sax.py) -------------------
    with _stage(stages, "strain"):
        strain_row = None
        radial_csv = os.path.join(data_dir, "strain_sa_radial.csv")
        circum_csv = os.path.join(data_dir, "strain_sa_circum.csv")
        for stale in (radial_csv, circum_csv):
            # never harvest a previous run's tables if this run's motion
            # dispatch declines the subject
            if os.path.exists(stale):
                os.remove(stale)
        if qc_ok:
            motion_dir = os.path.join(data_dir, "cine_motion")
            os.makedirs(motion_dir, exist_ok=True)
            try:
                kwargs = {} if cfg is None else {"cfg": cfg}
                sctx = start_sa_motion_dispatch(data_dir, motion_dir,
                                                eval_dice=eval_dice,
                                                register_batch=register_batch,
                                                mesh=mesh, device=device,
                                                **kwargs)
                if sctx is not None:
                    # motion_dir is deleted below: skip its per-frame VTKs
                    finish_sa_motion(sctx,
                                     os.path.join(data_dir, "strain_sa"),
                                     write_artifacts=False)
            finally:
                shutil.rmtree(motion_dir, ignore_errors=True)
            if os.path.exists(radial_csv) and os.path.exists(circum_csv):
                df_radial = _read_csv(radial_csv, index_col=0)
                df_circum = _read_csv(circum_csv, index_col=0)
                strain_row = ([df_circum.iloc[i, :].min()
                               for i in range(17)] +
                              [df_radial.iloc[i, :].max()
                               for i in range(17)])

    if result is not None:
        # per-subject slots: no cross-subject races beyond dict insert
        # (GIL-atomic)
        if vol_row is not None:
            result.volume_rows[subject] = vol_row
        if wt_row is not None:
            result.wt_rows[subject] = wt_row
        if wt_max_row is not None:
            result.wt_max_rows[subject] = wt_max_row
        if strain_row is not None:
            result.strain_rows[subject] = strain_row
        result.stage_seconds[subject] = stages
    return stages


def _select_subjects(data_root, subjects, start_idx, end_idx):
    """Sorted subject list, optionally sliced [start_idx:end_idx] — the
    reference eval scripts' manual sharding semantics
    (``eval_strain_sax.py:26-34``); end_idx < 0 means 'to the end'."""
    if subjects is None:
        subjects = [d for d in os.listdir(data_root)
                    if os.path.isdir(os.path.join(data_root, d))]
    subjects = sorted(subjects)
    end = end_idx if end_idx >= 0 else len(subjects)
    return subjects[start_idx:end]


def _run(data_root, subjects, start_idx, end_idx, workers, verbose,
         process) -> CohortResult:
    """Run ``process(subject_dir, result)`` over the selected subjects on
    the fleet."""
    subjects = _select_subjects(data_root, subjects, start_idx, end_idx)
    result = CohortResult()

    def one(subject: str):
        with span("ukbb.subject"):
            process(os.path.join(data_root, subject), result)

    t0 = time.time()
    result.fleet = run_fleet(subjects, one, workers=workers, verbose=verbose)
    result.wall_seconds = time.time() - t0
    return result


def run_cohort_sa(data_root: str, engine,
                  subjects: Optional[Sequence[str]] = None,
                  workers: int = 1, cfg=None, register_batch=None,
                  mesh=None,
                  eval_dice: bool = False, output_dir: Optional[str] = None,
                  verbose: bool = True, skip_existing_seg: bool = True,
                  start_idx: int = 0, end_idx: int = -1,
                  device=None) -> CohortResult:
    """Process a cohort end to end, subject by subject.

    ``workers`` worker threads each drive whole subjects.  The strain
    stage runs on ``device`` (default the card, or the first device of
    ``mesh``); ``mesh`` splits each subject's registration pair
    population over its devices (``reg.make_register_batch``).  Returns
    a :class:`CohortResult`; with ``output_dir`` set, writes the four
    aggregate CSVs in the reference CLIs' schemas.
    """
    dev = resolve_device_for(device, mesh)

    def process(data_dir, result):
        process_subject_sa(engine, data_dir, cfg=cfg,
                           register_batch=register_batch, mesh=mesh,
                           eval_dice=eval_dice, result=result,
                           skip_existing_seg=skip_existing_seg, device=dev)

    result = _run(data_root, subjects, start_idx, end_idx, workers,
                  verbose, process)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        write_cohort_csvs(result, output_dir)
    return result


@span("ukbb.io.csv")
def write_cohort_csvs(result: CohortResult, output_dir: str) -> None:
    """Aggregate CSVs in the reference CLI schemas
    (``eval_ventricular_volume.py:78-81``, ``eval_wall_thickness.py:64-80``,
    ``eval_strain_sax.py:66-75``)."""
    from ukbb_cardiac_tpu_torch.cli.eval_strain_sax import \
        COLUMNS as STRAIN_COLUMNS
    from ukbb_cardiac_tpu_torch.cli.eval_wall_thickness import (MAX_COLUMNS,
                                                                MEAN_COLUMNS)

    if result.volume_rows:
        pd.DataFrame.from_dict(result.volume_rows, orient="index").to_csv(
            os.path.join(output_dir, "table_ventricular_volume.csv"))
    if result.wt_rows:
        pd.DataFrame.from_dict(result.wt_rows, orient="index")\
            .set_axis(MEAN_COLUMNS, axis=1)\
            .to_csv(os.path.join(output_dir, "table_wall_thickness.csv"))
    if result.wt_max_rows:
        pd.DataFrame.from_dict(result.wt_max_rows, orient="index")\
            .set_axis(MAX_COLUMNS, axis=1)\
            .to_csv(os.path.join(output_dir, "table_wall_thickness_max.csv"))
    if result.strain_rows:
        pd.DataFrame.from_dict(result.strain_rows, orient="index")\
            .set_axis(STRAIN_COLUMNS, axis=1)\
            .to_csv(os.path.join(output_dir, "table_strain_sax.csv"))


def process_subject_full(engines: Dict[str, object], data_dir: str,
                         cfg=None, register_batch=None, mesh=None,
                         pressure_value: Optional[float] = None,
                         eval_dice: bool = False,
                         result: Optional[CohortResult] = None,
                         skip_existing_seg: bool = True,
                         device=None) -> Dict[str, float]:
    """The COMPLETE per-subject pipeline (``demo_pipeline.py:63-122``):

        SA chain (segment → volumes → wall thickness → strain)
        → LA deploys (la_2ch, la_4ch, la_4ch --seg4) → atrial volumes
        → LA strain → aortic deploy → aortic areas

    ``engines``: {'sa': InferenceEngine, 'la_2ch': ..., 'la_4ch': ...,
    'seg4': ..., 'ao': AorticEngine} — any entry may be absent or None to
    skip its stage (its phenotype stages then skip on missing files, like
    the reference).  ``pressure_value``: this subject's central pulse
    pressure for distensibility (None or NaN → NaN distensibility).
    Strain stages run on ``device`` (default the card, or the first
    device of ``mesh``) with ``cfg`` (default ``RegConfig()``), their
    pair populations split over ``mesh`` if given; ``register_batch``, a
    prebuilt registration for the SA crop, serves the SA strain only (the
    LA crop has a shape of its own).  The aortic deploy runs on its
    engine's device.
    """
    from ukbb_cardiac_tpu_torch.infer.deploy import (_finish_subject_sequence,
                                                     _start_subject_sequence)
    from ukbb_cardiac_tpu_torch.infer.deploy_ao import deploy_subject_ao
    from ukbb_cardiac_tpu_torch.phenotype.aorta import (aortic_area_measures,
                                                        aortic_row)
    from ukbb_cardiac_tpu_torch.phenotype.atrium import atrial_volume_measures
    from ukbb_cardiac_tpu_torch.phenotype.qc import la_pass_quality_control
    from ukbb_cardiac_tpu_torch.phenotype.strain_la import (
        finish_la_motion, start_la_motion_dispatch)

    subject = os.path.basename(data_dir.rstrip("/"))
    stages = process_subject_sa(
        engines.get("sa"), data_dir, cfg=cfg, register_batch=register_batch,
        mesh=mesh, eval_dice=eval_dice, result=result,
        skip_existing_seg=skip_existing_seg,
        device=device) if engines.get("sa") else {}

    # --- LA deploys (deploy_network.py la_2ch / la_4ch / --seg4) ----------
    with _stage(stages, "segment_la"):
        for seq, seg4 in (("la_2ch", False), ("la_4ch", False),
                          ("la_4ch", True)):
            eng = engines.get("seg4" if seg4 else seq)
            if eng is None:
                continue
            ctx = _start_subject_sequence(eng, data_dir, seq, seg4=seg4,
                                          force=not skip_existing_seg)
            if ctx is not None:
                _finish_subject_sequence(ctx, seq, seg4=seg4, save_seg=True)

    # --- atrial volumes (eval_atrial_volume.py) ---------------------------
    with _stage(stages, "atrial_volumes"):
        atrial_row = atrial_volume_measures(data_dir)

    # --- LA strain (eval_strain_lax.py) -----------------------------------
    with _stage(stages, "strain_la"):
        la_strain_row = None
        longit_csv = os.path.join(data_dir, "strain_la_4ch_longit.csv")
        if os.path.exists(longit_csv):
            os.remove(longit_csv)
        seg4_ed = os.path.join(data_dir, "seg4_la_4ch_ED.nii.gz")
        if os.path.exists(seg4_ed) and \
                os.path.exists(os.path.join(data_dir,
                                            "seg_sa_ED.nii.gz")) and \
                la_pass_quality_control(seg4_ed):
            motion_dir = os.path.join(data_dir, "cine_la_motion")
            os.makedirs(motion_dir, exist_ok=True)
            try:
                kwargs = {} if cfg is None else {"cfg": cfg}
                ctx = start_la_motion_dispatch(data_dir, motion_dir,
                                               mesh=mesh,
                                               eval_dice=eval_dice,
                                               device=device, **kwargs)
                if ctx is not None:
                    # motion_dir is deleted below: skip its per-frame VTKs
                    finish_la_motion(ctx, os.path.join(data_dir,
                                                       "strain_la_4ch"),
                                     eval_dice=eval_dice,
                                     write_artifacts=False)
            finally:
                shutil.rmtree(motion_dir, ignore_errors=True)
            if os.path.exists(longit_csv):
                df_l = _read_csv(longit_csv, index_col=0)
                la_strain_row = [df_l.iloc[i, :].min() for i in range(7)]

    # --- aortic deploy + areas (deploy_network_ao.py, eval_aortic_area) ---
    with _stage(stages, "aortic"):
        ao_row = None
        ao_engine = engines.get("ao")
        if ao_engine is not None and \
                os.path.exists(os.path.join(data_dir, "ao.nii.gz")):
            if not skip_existing_seg:
                seg_ao = os.path.join(data_dir, "seg_ao.nii.gz")
                if os.path.exists(seg_ao):
                    os.remove(seg_ao)
            deploy_subject_ao(ao_engine, data_dir)
            pp = float("nan") if pressure_value is None else pressure_value
            val = aortic_area_measures(data_dir, pp)
            if val is not None:
                ao_row = aortic_row(val)

    if result is not None:
        if atrial_row is not None:
            result.atrial_rows[subject] = atrial_row
        if la_strain_row is not None:
            result.la_strain_rows[subject] = la_strain_row
        if ao_row is not None:
            result.aortic_rows[subject] = ao_row
        result.stage_seconds.setdefault(subject, {}).update(stages)
    return stages


def run_cohort_full(data_root: str, engines: Dict[str, object],
                    subjects: Optional[Sequence[str]] = None,
                    workers: int = 1, cfg=None, mesh=None,
                    pressure=None, eval_dice: bool = False,
                    output_dir: Optional[str] = None,
                    verbose: bool = True, skip_existing_seg: bool = True,
                    start_idx: int = 0, end_idx: int = -1,
                    device=None) -> CohortResult:
    """The complete per-subject pipeline over a cohort on ``workers``
    threads — ``demo_pipeline.py`` per subject, not stage by stage.
    ``pressure``: optional mapping eid → central pulse pressure (e.g. the
    Series of :func:`~ukbb_cardiac_tpu_torch.phenotype.aorta.
    load_central_pulse_pressure`).  ``cfg`` and ``mesh``: as
    :func:`process_subject_full`'s."""
    dev = resolve_device_for(device, mesh)

    def process(data_dir, result):
        pp = None
        if pressure is not None:
            try:
                pp = float(pressure[int(os.path.basename(data_dir))])
            except (KeyError, ValueError, TypeError):
                pp = None
        process_subject_full(engines, data_dir, cfg=cfg, mesh=mesh,
                             pressure_value=pp,
                             eval_dice=eval_dice, result=result,
                             skip_existing_seg=skip_existing_seg,
                             device=dev)

    result = _run(data_root, subjects, start_idx, end_idx, workers,
                  verbose, process)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        write_cohort_csvs(result, output_dir)
        write_cohort_full_csvs(result, output_dir)
    return result


@span("ukbb.io.csv")
def write_cohort_full_csvs(result: CohortResult, output_dir: str) -> None:
    """Aggregate CSVs for the LA and aortic stages (reference schemas:
    ``eval_atrial_volume.py:165-168``, ``eval_strain_lax.py:66-75``,
    ``eval_aortic_area.py:86-90``)."""
    from ukbb_cardiac_tpu_torch.cli.eval_strain_lax import \
        COLUMNS as LA_STRAIN_COLUMNS
    from ukbb_cardiac_tpu_torch.phenotype import aorta, atrium

    if result.atrial_rows:
        # atrial_volume_measures builds its dict in the columns' order
        pd.DataFrame.from_dict(result.atrial_rows, orient="index")\
            .set_axis(atrium.COLUMNS, axis=1)\
            .to_csv(os.path.join(output_dir, "table_atrial_volume.csv"))
    if result.la_strain_rows:
        pd.DataFrame.from_dict(result.la_strain_rows, orient="index")\
            .set_axis(LA_STRAIN_COLUMNS, axis=1)\
            .to_csv(os.path.join(output_dir, "table_strain_lax.csv"))
    if result.aortic_rows:
        pd.DataFrame.from_dict(result.aortic_rows, orient="index")\
            .set_axis(aorta.COLUMNS, axis=1)\
            .to_csv(os.path.join(output_dir, "table_aortic_area.csv"))
