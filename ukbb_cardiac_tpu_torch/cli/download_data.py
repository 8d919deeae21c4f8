"""CLI twin of ``data/download_data_ukbb_general.py`` — ukbfetch bulk
download (fields 20208/20209) + conversion to NIfTI.

Counterpart of ``ukbb_cardiac_tpu/cli/download_data.py``: the same flags and
outputs.  Host work only: no card is needed.
"""

from __future__ import annotations

import argparse

import pandas as pd

from ukbb_cardiac_tpu_torch.data.download import download_and_convert


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--eid_csv", required=True,
                        help="CSV with an 'eid' column of subject IDs.")
    parser.add_argument("--ukbkey", required=True,
                        help="Path to the UK Biobank authentication key.")
    parser.add_argument("--work_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--fields", nargs="+", type=int,
                        default=[20208, 20209],
                        help="Bulk field IDs (20208 = long axis, "
                             "20209 = short axis).")
    parser.add_argument("--ukbfetch", default="ukbfetch")
    args = parser.parse_args(argv)

    eids = [str(e) for e in pd.read_csv(args.eid_csv)["eid"].tolist()]
    download_and_convert(eids, args.ukbkey, args.work_dir, args.out_dir,
                         tuple(args.fields), args.ukbfetch)


if __name__ == "__main__":
    main()
