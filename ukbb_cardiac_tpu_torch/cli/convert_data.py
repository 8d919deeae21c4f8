"""CLI twin of ``data/convert_data_ukbb2964.py`` — convert application
zips (DICOM + optional cvi42 workspace) into per-subject NIfTI trees.

Counterpart of ``ukbb_cardiac_tpu/cli/convert_data.py``: the same flags and
outputs.  Host work only: no card is needed.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil

from ukbb_cardiac_tpu_torch.data.download import convert_subject, unpack_zip


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_dir", required=True,
                        help="Directory of per-subject zips: <eid>.zip (+ "
                             "<eid>_cvi42.zip when annotated).")
    parser.add_argument("--output_dir", required=True)
    args = parser.parse_args(argv)

    for zip_name in sorted(glob.glob(os.path.join(args.input_dir, "*.zip"))):
        base = os.path.basename(zip_name)
        if base.endswith("_cvi42.zip"):
            continue
        eid = os.path.splitext(base)[0]
        print(eid)
        out_dir = os.path.join(args.output_dir, eid)
        if os.path.isdir(out_dir) and os.listdir(out_dir):
            continue  # idempotent resume
        work = os.path.join(args.output_dir, f".work_{eid}")
        os.makedirs(work, exist_ok=True)
        unpack_zip(zip_name, work)
        cvi42_zip = os.path.join(args.input_dir, f"{eid}_cvi42.zip")
        cvi42_xml = None
        if os.path.exists(cvi42_zip):
            unpack_zip(cvi42_zip, work)
            xmls = glob.glob(os.path.join(work, "*.cvi42wsx"))
            cvi42_xml = xmls[0] if xmls else None
        convert_subject(work, out_dir, cvi42_xml)
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
