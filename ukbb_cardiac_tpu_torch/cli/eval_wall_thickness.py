"""CLI twin of ``short_axis/eval_wall_thickness.py``.

Reference quirk, consciously fixed: the reference requires
``--output_max_csv`` (``eval_wall_thickness.py:25``) but
``demo_pipeline.py:73-74`` does not pass it, so the demo would crash as
shipped (SURVEY.md "known quirks").  Here it is optional and defaults to
``<output_csv stem>_max.csv``.

The port's copy of ``ukbb_cardiac_tpu/cli/eval_wall_thickness.py``.
"""

from __future__ import annotations

import argparse
import os

import pandas as pd

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.phenotype.qc import sa_pass_quality_control
from ukbb_cardiac_tpu_torch.phenotype.wall_thickness import evaluate_wall_thickness

MEAN_COLUMNS = [f"WT_AHA_{i} (mm)" for i in range(1, 17)] + ["WT_Global (mm)"]
MAX_COLUMNS = [f"WT_Max_AHA_{i} (mm)" for i in range(1, 17)] + ["WT_Max_Global (mm)"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", metavar="dir_name", required=True)
    parser.add_argument("--output_csv", metavar="csv_name", required=True)
    parser.add_argument("--output_max_csv", metavar="max_csv_name", default="")
    parser.add_argument("--bullseye_png", default="",
                        help="Also render the mean-thickness AHA bull's-eye "
                             "averaged over subjects (phenotype/bullseye.py).")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'.  Wall thickness is "
                             "host code; the flag is checked like every "
                             "entry point's, so it raises without a card "
                             "unless 'cpu' is given.")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    output_max_csv = args.output_max_csv
    if not output_max_csv:
        stem, ext = os.path.splitext(args.output_csv)
        output_max_csv = f"{stem}_max{ext or '.csv'}"

    table, processed = [], []
    table_max, processed_max = [], []
    for data in sorted(os.listdir(args.data_dir)):
        print(data)
        data_dir = os.path.join(args.data_dir, data)
        seg_sa_name = os.path.join(data_dir, "seg_sa_ED.nii.gz")
        if not os.path.exists(seg_sa_name):
            continue
        if not sa_pass_quality_control(seg_sa_name):
            continue
        evaluate_wall_thickness(seg_sa_name,
                                os.path.join(data_dir, "wall_thickness_ED"))
        mean_csv = os.path.join(data_dir, "wall_thickness_ED.csv")
        if os.path.exists(mean_csv):
            df = pd.read_csv(mean_csv, index_col=0)
            table.append(df["Thickness"].values)
            processed.append(data)
        max_csv = os.path.join(data_dir, "wall_thickness_ED_max.csv")
        if os.path.exists(max_csv):
            df = pd.read_csv(max_csv, index_col=0)
            table_max.append(df["Thickness_Max"].values)
            processed_max.append(data)

    df_mean = pd.DataFrame(table, index=processed, columns=MEAN_COLUMNS)
    df_mean.to_csv(args.output_csv)
    pd.DataFrame(table_max, index=processed_max,
                 columns=MAX_COLUMNS).to_csv(output_max_csv)

    if args.bullseye_png and len(df_mean):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ukbb_cardiac_tpu_torch.phenotype.bullseye import plot_bulls_eye

        seg16 = df_mean.iloc[:, :16].mean(axis=0).values
        plt.figure(figsize=(5, 5))
        plot_bulls_eye(seg16, vmin=float(seg16.min()), vmax=float(seg16.max()))
        plt.title("Mean wall thickness (mm)")
        plt.savefig(args.bullseye_png, dpi=150, bbox_inches="tight")
        plt.close()


if __name__ == "__main__":
    main()
