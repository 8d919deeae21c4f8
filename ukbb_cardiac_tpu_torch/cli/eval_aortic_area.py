"""CLI twin of ``aortic/eval_aortic_area.py``: per-subject aortic areas
and distensibility from ``ao.nii.gz`` + ``seg_ao.nii.gz`` (host code; no
device).

Usage:
  python -m ukbb_cardiac_tpu_torch.cli.eval_aortic_area --data_dir <dir> \
      --pressure_csv <bp.csv> --output_csv <table.csv>
"""

from __future__ import annotations

import argparse

from ukbb_cardiac_tpu_torch.phenotype.aorta import evaluate_aortic_area_dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", metavar="dir_name", required=True)
    parser.add_argument("--pressure_csv", metavar="csv_name", required=True)
    parser.add_argument("--output_csv", metavar="csv_name", required=True)
    args = parser.parse_args(argv)
    evaluate_aortic_area_dataset(args.data_dir, args.pressure_csv,
                                 args.output_csv)


if __name__ == "__main__":
    main()
