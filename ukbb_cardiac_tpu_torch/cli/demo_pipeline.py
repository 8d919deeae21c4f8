"""CLI twin of ``demo_pipeline.py`` — the end-to-end demo on two subjects.

Counterpart of ``ukbb_cardiac_tpu/cli/demo_pipeline.py``.  The reference
downloads demo images and TF checkpoints from
``https://www.doc.ic.ac.uk/~wbai/data/ukbb_cardiac/`` and shells out to
each stage with files as the interchange format
(``demo_pipeline.py:28-122``).  Here every stage is an in-process call
of the port's functions and CLIs, on ``--device`` (default ``cuda``;
without a card it raises unless ``--device cpu`` is given); a TF
checkpoint is converted to a bundle on first use (``ckpt/tf_reader.py``,
which needs tensorflow on the host).

Stages, in the reference's order (``demo_pipeline.py:63-122``):
  1. deploy FCN_sa              → seg_sa.nii.gz
  2. eval_ventricular_volume    → csv
  3. eval_wall_thickness        → csv
  4. eval_strain_sax (B-spline FFD on the card; no MIRTK)
  5. deploy FCN_la_2ch / FCN_la_4ch / FCN_la_4ch_seg4
  6. eval_atrial_volume
  7. eval_strain_lax
  8. deploy UNet-LSTM_ao        → seg_ao.nii.gz
  9. eval_aortic_area
Each stage's seconds are printed at the end.
"""

from __future__ import annotations

import argparse
import os
import urllib.request

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.utils.timing import StageTimer

URL_BASE = "https://www.doc.ic.ac.uk/~wbai/data/ukbb_cardiac/"
DEMO_MODELS = ["FCN_sa", "FCN_la_2ch", "FCN_la_4ch", "FCN_la_4ch_seg4",
               "UNet-LSTM_ao"]


def download_demo_data(data_dir: str, model_dir: str,
                       csv_dir: str = None) -> None:
    """Fetch the reference's demo images, BP spreadsheet and checkpoints
    (``demo_pipeline.py:28-54``); needs network access.  The BP
    spreadsheet lands in ``csv_dir``, where ``main`` later reads it
    (default: ``demo_csv`` beside ``data_dir``).  Files already present
    are not fetched again."""
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(model_dir, exist_ok=True)
    for i in (1, 2):
        subject_dir = os.path.join(data_dir, str(i))
        os.makedirs(subject_dir, exist_ok=True)
        for seq in ("sa", "la_2ch", "la_4ch", "ao"):
            name = f"demo_image/{i}/{seq}.nii.gz"
            dest = os.path.join(subject_dir, f"{seq}.nii.gz")
            if not os.path.exists(dest):
                urllib.request.urlretrieve(URL_BASE + name, dest)
    if csv_dir is None:
        csv_dir = os.path.join(os.path.dirname(os.path.abspath(data_dir)),
                               "demo_csv")
    os.makedirs(csv_dir, exist_ok=True)
    bp = os.path.join(csv_dir, "blood_pressure_info.csv")
    if not os.path.exists(bp):
        urllib.request.urlretrieve(
            URL_BASE + "demo_csv/blood_pressure_info.csv", bp)
    for model in DEMO_MODELS:
        for suffix in ("meta", "index", "data-00000-of-00001"):
            name = f"trained_model/{model}.ckpt.{suffix}"
            dest = os.path.join(model_dir, f"{model}.ckpt.{suffix}")
            if not os.path.exists(dest):
                urllib.request.urlretrieve(URL_BASE + name, dest)


def resolve_model(model_dir: str, name: str) -> str:
    """The bundle ``<name>.npz`` if present, else the TF checkpoint
    ``<name>.ckpt`` converted into it."""
    bundle = os.path.join(model_dir, f"{name}.npz")
    if os.path.exists(bundle):
        return bundle
    ckpt = os.path.join(model_dir, f"{name}.ckpt")
    if os.path.exists(ckpt + ".index"):
        from ukbb_cardiac_tpu_torch.ckpt.tf_reader import \
            convert_tf_checkpoint
        return convert_tf_checkpoint(ckpt, bundle)
    raise FileNotFoundError(f"no model {name} under {model_dir}")


def main(argv=None) -> dict:
    """Run the demo; returns the stages' seconds
    (``StageTimer.summary()``)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", default="demo_image")
    parser.add_argument("--model_dir", default="trained_model")
    parser.add_argument("--csv_dir", default="demo_csv")
    parser.add_argument("--download", action="store_true",
                        help="Download demo data + checkpoints first.")
    parser.add_argument("--skip_strain", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'.")
    args = parser.parse_args(argv)

    resolve_device(args.device)   # without a card: raise before any work
    if args.download:
        download_demo_data(args.data_dir, args.model_dir, args.csv_dir)
    os.makedirs(args.csv_dir, exist_ok=True)

    from ukbb_cardiac_tpu_torch.cli import (eval_aortic_area,
                                            eval_atrial_volume,
                                            eval_strain_lax, eval_strain_sax,
                                            eval_ventricular_volume,
                                            eval_wall_thickness)
    from ukbb_cardiac_tpu_torch.infer.deploy import deploy_dataset
    from ukbb_cardiac_tpu_torch.infer.deploy_ao import deploy_dataset_ao

    timer = StageTimer()
    device = ["--device", args.device]

    def csv(name):
        return os.path.join(args.csv_dir, name)

    print("Deploying the segmentation network ...")
    with timer.span("deploy_sa"):
        deploy_dataset(resolve_model(args.model_dir, "FCN_sa"),
                       args.data_dir, seq_name="sa", device=args.device)
    print("Evaluating ventricular volumes ...")
    with timer.span("ventricular_volume"):
        eval_ventricular_volume.main([
            "--data_dir", args.data_dir,
            "--output_csv", csv("table_ventricular_volume.csv")])
    print("Evaluating myocardial wall thickness ...")
    with timer.span("wall_thickness"):
        eval_wall_thickness.main([
            "--data_dir", args.data_dir,
            "--output_csv", csv("table_wall_thickness.csv"), *device])
    if not args.skip_strain:
        print("Evaluating short-axis strain (B-spline FFD motion "
              "tracking) ...")
        with timer.span("strain_sax"):
            eval_strain_sax.main([
                "--data_dir", args.data_dir,
                "--output_csv", csv("table_strain_sax.csv"), *device])

    with timer.span("deploy_la"):
        for seq, model, seg4 in (("la_2ch", "FCN_la_2ch", False),
                                 ("la_4ch", "FCN_la_4ch", False),
                                 ("la_4ch", "FCN_la_4ch_seg4", True)):
            deploy_dataset(resolve_model(args.model_dir, model),
                           args.data_dir, seq_name=seq, seg4=seg4,
                           device=args.device)
    print("Evaluating atrial volumes ...")
    with timer.span("atrial_volume"):
        eval_atrial_volume.main([
            "--data_dir", args.data_dir,
            "--output_csv", csv("table_atrial_volume.csv")])
    if not args.skip_strain:
        print("Evaluating long-axis strain ...")
        with timer.span("strain_lax"):
            eval_strain_lax.main([
                "--data_dir", args.data_dir,
                "--output_csv", csv("table_strain_lax.csv"), *device])

    print("Deploying the aortic segmentation network ...")
    with timer.span("deploy_ao"):
        deploy_dataset_ao(resolve_model(args.model_dir, "UNet-LSTM_ao"),
                          args.data_dir, device=args.device)
    print("Evaluating aortic areas ...")
    bp_csv = csv("blood_pressure_info.csv")
    if os.path.exists(bp_csv):
        with timer.span("aortic_area"):
            eval_aortic_area.main([
                "--data_dir", args.data_dir, "--pressure_csv", bp_csv,
                "--output_csv", csv("table_aortic_area.csv")])
    else:
        print(f"  Skipping: {bp_csv} not found (distensibility needs the "
              f"central pulse pressure spreadsheet; use --download or "
              f"place it in --csv_dir). No table_aortic_area.csv written.")
    print("Done.")
    print(timer.report())
    return timer.summary()


if __name__ == "__main__":
    main()
