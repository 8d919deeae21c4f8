"""CLI twin of ``long_axis/eval_atrial_volume.py`` (host code, like
``eval_ventricular_volume``)."""

from __future__ import annotations

import argparse

from ukbb_cardiac_tpu_torch.phenotype.atrium import \
    evaluate_atrial_volume_dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", metavar="dir_name", required=True)
    parser.add_argument("--output_csv", metavar="csv_name", required=True)
    args = parser.parse_args(argv)
    evaluate_atrial_volume_dataset(args.data_dir, args.output_csv)


if __name__ == "__main__":
    main()
