"""Whole-cohort end-to-end processing with cross-stage overlap, on the card.

Counterpart of ``ukbb_cardiac_tpu/cli/run_cohort.py``: one command runs

    segmentation → ventricular volumes → wall thickness → strain

per subject over a worker pool, and with any of ``--model_path_la_2ch /
--model_path_la_4ch / --model_path_seg4 / --model_path_ao`` the complete
``demo_pipeline.py`` chain (LA deploys → atrial volumes → LA strain →
aortic deploy → aortic areas); ``--pressure_csv`` supplies the Vicorder
central pulse pressures for the aortic distensibility.  Outputs per
subject match the individual CLIs file for file; aggregate CSVs go to
``--output_dir`` in the same schemas, and the summary line, manifest and
exit code are the JAX CLI's.

The JAX CLI's flags plus ``--device`` (default ``cuda``; without a card it
raises unless ``--device cpu`` is given).  ``--mesh_devices n`` (n > 1)
splits each subject's registration pairs over ``make_mesh(n,
device=--device)``: n cards, or n CPU replicas with ``--device cpu``.

``--trace_dir <dir>`` runs the cohort (from the engines' loading to the
last subject) under ``torch.profiler`` and writes the CPU and card
timeline to ``<dir>`` as a Chrome trace JSON
(``utils/timing.py::device_trace``; Perfetto, ``chrome://tracing`` or
TensorBoard open it).  The program's own spans lie on the card's
timeline there, every name starting with ``ukbb.``:

- ``ukbb.subject`` around each subject, and ``ukbb.stage.<key>`` around
  each stage, the stretch that the manifest's ``stage_seconds[<key>]``
  times (``segment``, ``volumes``, ``wall_thickness``, ``strain``; in
  full mode also ``segment_la``, ``atrial_volumes``, ``strain_la``,
  ``aortic``);
- ``ukbb.io.nifti.load``, ``ukbb.io.nifti.save``, ``ukbb.io.vtk``,
  ``ukbb.io.csv``: file reads and writes;
- ``ukbb.engine.dispatch``, ``ukbb.engine.wait``, ``ukbb.deploy.write``:
  a cine queued on the card, the wait for its labels, and the host work
  on them around the NIfTI writes;
- ``ukbb.program.warmup``, ``.capture``, ``.replay``, ``.release``: the
  CUDA graphs' first calls, captures, replays and released pools;
- ``ukbb.reg.dispatch``: the strain stage's registration queued;
- ``ukbb.phenotype.volumes``, ``.qc``, ``.wall_thickness``,
  ``.strain.crop``, ``.strain.contours``, ``.strain.fetch``,
  ``.strain.tables``, ``.atrial_volumes``, ``.aortic_qc``,
  ``.aortic_areas``: each phenotype stage's host work;
- ``ukbb.kernels.build``: the CUDA kernels compiled at first use.

Without ``--trace_dir`` a span costs one flag read.  ``torch.profiler``
records the host spans of the thread that started it, which runs every
subject at ``--workers 1``; with more workers their spans are not in the
trace (their kernels are).

Usage:
  python -m ukbb_cardiac_tpu_torch.cli.run_cohort --data_dir <dir> \
      --model_path <FCN_sa.npz> --output_dir <csv dir>
"""

from __future__ import annotations

import argparse
import json

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", metavar="dir_name", required=True)
    parser.add_argument("--model_path", metavar="path", required=True,
                        help="FCN model bundle (.npz)")
    parser.add_argument("--output_dir", metavar="dir_name", required=True,
                        help="Aggregate CSV directory")
    parser.add_argument("--workers", type=int, default=1,
                        help="Subjects in flight (threads). 1 by default, "
                             "the count every benchmark cell runs (PERF.md "
                             "section 4); more workers have no cell yet "
                             "(ROADMAP.md C2, F1).")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 activations for segmentation")
    parser.add_argument("--eval_dice", action="store_true")
    parser.add_argument("--force", action="store_true",
                        help="Re-segment even when seg_sa.nii.gz exists")
    parser.add_argument("--manifest", metavar="json_name", default="",
                        help="Write the fleet manifest (per-subject "
                             "status/seconds) to this JSON file")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="Split each subject's registration pair "
                             "population over this many devices of "
                             "--device (0 = one).")
    parser.add_argument("--model_path_la_2ch", metavar="path", default="")
    parser.add_argument("--model_path_la_4ch", metavar="path", default="")
    parser.add_argument("--model_path_seg4", metavar="path", default="")
    parser.add_argument("--model_path_ao", metavar="path", default="",
                        help="Aortic model bundle (.npz, UNet-LSTM)")
    parser.add_argument("--pressure_csv", metavar="csv_name", default="",
                        help="UKB blood-pressure spreadsheet for aortic "
                             "distensibility (fields 12678-2.0/2.1)")
    parser.add_argument("--start_idx", type=int, default=0,
                        help="First subject index (sorted order) — the "
                             "reference eval scripts' manual sharding "
                             "flags (eval_strain_sax.py:26-34)")
    parser.add_argument("--end_idx", type=int, default=-1,
                        help="One past the last subject index (-1 = all)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    parser.add_argument("--trace_dir", default="",
                        help="Write a torch.profiler trace (CPU and card, "
                             "with the program's ukbb.* spans) here as a "
                             "Chrome trace JSON.")
    args = parser.parse_args(argv)

    if args.pressure_csv and not args.model_path_ao:
        parser.error("--pressure_csv is only used by the aortic stage; "
                     "pass --model_path_ao as well")

    from ukbb_cardiac_tpu_torch.utils.timing import device_trace

    with device_trace(args.trace_dir):
        result = _run(args)
    n_ok = len(result.fleet.succeeded)
    print(f"cohort: {n_ok} succeeded, {len(result.fleet.failed)} failed, "
          f"{len(result.fleet.skipped)} skipped in "
          f"{result.wall_seconds:.1f}s "
          f"({result.subjects_per_s:.3f} subjects/s)")
    if args.manifest:
        with open(args.manifest, "w") as f:
            json.dump({**result.fleet.to_manifest(),
                       "wall_seconds": result.wall_seconds,
                       "stage_seconds": result.stage_seconds}, f, indent=2)
    return 0 if not result.fleet.failed else 1


def _run(args):
    """Load the engines, run the cohort, release the engines' programs;
    returns the :class:`~ukbb_cardiac_tpu_torch.parallel.cohort.
    CohortResult`."""
    from ukbb_cardiac_tpu_torch import resolve_device
    from ukbb_cardiac_tpu_torch.infer.deploy import load_segmentation_model
    from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
    from ukbb_cardiac_tpu_torch.parallel.cohort import (run_cohort_full,
                                                        run_cohort_sa)

    device = resolve_device(args.device)
    mesh = None
    if args.mesh_devices > 1:
        from ukbb_cardiac_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(args.mesh_devices, device=args.device)
    dtype = torch.bfloat16 if args.bf16 else None

    def slice_engine(path):
        return InferenceEngine(load_segmentation_model(path, device, dtype))

    engine = slice_engine(args.model_path)
    engines = {"sa": engine}
    common = dict(workers=args.workers, eval_dice=args.eval_dice,
                  output_dir=args.output_dir,
                  skip_existing_seg=not args.force,
                  start_idx=args.start_idx, end_idx=args.end_idx,
                  mesh=mesh, device=device)
    if any((args.model_path_la_2ch, args.model_path_la_4ch,
            args.model_path_seg4, args.model_path_ao)):
        for key, path in (("la_2ch", args.model_path_la_2ch),
                          ("la_4ch", args.model_path_la_4ch),
                          ("seg4", args.model_path_seg4)):
            if path:
                engines[key] = slice_engine(path)
        if args.model_path_ao:
            from ukbb_cardiac_tpu_torch.infer.deploy_ao import \
                load_aortic_engine
            engines["ao"] = load_aortic_engine(args.model_path_ao, device,
                                               dtype)
        pressure = None
        if args.pressure_csv:
            from ukbb_cardiac_tpu_torch.phenotype.aorta import \
                load_central_pulse_pressure
            pressure = load_central_pulse_pressure(args.pressure_csv)
        result = run_cohort_full(args.data_dir, engines, pressure=pressure,
                                 **common)
    else:
        result = run_cohort_sa(args.data_dir, engine, **common)
    # the engines go with this run: their graphs' pools go back now
    for eng in engines.values():
        eng.release_programs()
    return result


if __name__ == "__main__":
    raise SystemExit(main())
