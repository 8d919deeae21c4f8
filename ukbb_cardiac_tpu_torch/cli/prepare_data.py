"""CLI twin of ``data/prepare_data_ukbb2964.py`` — build the training set.

Steps (``prepare_data_ukbb2964.py``): link annotated subjects, extract
ED/ES frames, per-sequence QC with an optional blacklist, and a
train/validation/test split with ICC subjects kept in the test set.


Counterpart of ``ukbb_cardiac_tpu/cli/prepare_data.py``: the same flags and
outputs.  Host work only: no card is needed.
"""

from __future__ import annotations

import argparse
import os

import pandas as pd

from ukbb_cardiac_tpu_torch.data.prepare import (
    extract_ed_es_frames,
    link_annotated_subjects,
    link_split,
    quality_control_subjects,
    split_dataset,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--orig_dir", default="",
                        help="Converted-subject tree (step 1 input); skip "
                             "linking if empty.")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--csv_dir", required=True)
    parser.add_argument("--dest_dir", required=True,
                        help="Root for <seq>/{train,validation,test} links.")
    parser.add_argument("--seqs", nargs="+", default=["sa", "la_2ch", "la_4ch"])
    parser.add_argument("--n_validation", type=int, default=300)
    parser.add_argument("--n_test", type=int, default=600)
    parser.add_argument("--icc_csv", default="")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if args.orig_dir:
        link_annotated_subjects(args.orig_dir, args.data_dir, tuple(args.seqs))
    extract_ed_es_frames(args.data_dir, tuple(args.seqs))

    os.makedirs(args.csv_dir, exist_ok=True)
    icc_list = []
    if args.icc_csv and os.path.exists(args.icc_csv):
        icc_list = sorted(set(pd.read_csv(args.icc_csv, index_col=0).index))

    for seq in args.seqs:
        bad_csv = os.path.join(args.csv_dir, f"bad_eid_{seq}.csv")
        bad = (pd.read_csv(bad_csv)["eid"].tolist()
               if os.path.exists(bad_csv) else [])
        good = quality_control_subjects(args.data_dir, seq, bad)
        pd.DataFrame(good, columns=["eid"]).to_csv(
            os.path.join(args.csv_dir, f"good_eid_{seq}.csv"), index=None)

        split = split_dataset(good, args.n_validation, args.n_test, icc_list,
                              seed=args.seed)
        for k, v in split.items():
            pd.DataFrame(v, columns=["eid"]).to_csv(
                os.path.join(args.csv_dir, f"{seq}_{k}.csv"), index=None)
        link_split(args.data_dir, args.dest_dir, seq, split)


if __name__ == "__main__":
    main()
