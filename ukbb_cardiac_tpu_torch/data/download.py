"""UK Biobank bulk download + conversion.

Counterpart of ``ukbb_cardiac_tpu/data/download.py`` (a copy).

Twins of ``data/download_data_ukbb_general.py`` (ukbfetch batch download
of fields 20208/20209, unzip, manifest-driven series sort, conversion)
and ``data/convert_data_ukbb2964.py`` (application-2964 zips with cvi42
annotations).  ``ukbfetch`` is UK Biobank's authenticated downloader and
stays an external tool; everything after the download
uses this framework's own DICOM/cvi42/NIfTI code.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import zipfile
from typing import Optional, Sequence

import pandas as pd

from ukbb_cardiac_tpu_torch.data.biobank import Biobank_Dataset, process_manifest
from ukbb_cardiac_tpu_torch.data.cvi42 import parseFile


def unpack_zip(zip_name: str, dest_dir: str) -> None:
    with zipfile.ZipFile(zip_name) as z:
        z.extractall(dest_dir)


def sort_dicoms_by_manifest(dicom_dir: str) -> None:
    """Move DICOMs into per-series subdirectories named by the manifest's
    series descriptions (``download_data_ukbb_general.py:93-100``)."""
    manifest = os.path.join(dicom_dir, "manifest.csv")
    manifest_cleaned = os.path.join(dicom_dir, "manifest2.csv")
    if not os.path.exists(manifest):
        cands = glob.glob(os.path.join(dicom_dir, "manifest*.csv"))
        if not cands:
            raise FileNotFoundError(f"no manifest in {dicom_dir}")
        manifest = cands[0]
    process_manifest(manifest, manifest_cleaned)
    df = pd.read_csv(manifest_cleaned, on_bad_lines="skip")
    for _, row in df.iterrows():
        series = str(row["series discription"]
                     if "series discription" in df.columns
                     else row["series description"]).strip()
        series_dir = os.path.join(dicom_dir, series)
        os.makedirs(series_dir, exist_ok=True)
        src = os.path.join(dicom_dir, str(row["filename"]))
        if os.path.exists(src):
            shutil.move(src, series_dir)


def download_subject(eid: str, field_ids: Sequence[int], ukbkey: str,
                     out_dir: str, ukbfetch: str = "ukbfetch") -> bool:
    """Fetch one subject's imaging zips via ukbfetch
    (``download_data_ukbb_general.py:63-78``). Returns success."""
    os.makedirs(out_dir, exist_ok=True)
    batch_file = os.path.join(out_dir, f"batch_{eid}.txt")
    with open(batch_file, "w") as f:
        for fid in field_ids:
            f.write(f"{eid} {fid}_2_0\n")
    result = subprocess.run(
        [ukbfetch, f"-b{batch_file}", f"-a{ukbkey}"],
        cwd=out_dir, capture_output=True, text=True)
    if result.returncode != 0:
        print(f"ukbfetch failed for {eid}: {result.stderr}")
        return False
    return True


def convert_subject(dicom_root: str, output_dir: str,
                    cvi42_xml: Optional[str] = None) -> None:
    """DICOM (optionally + cvi42 workspace) → NIfTI for one subject
    (``convert_data_ukbb2964.py:47-98``)."""
    os.makedirs(output_dir, exist_ok=True)
    cvi42_dir = None
    if cvi42_xml:
        cvi42_dir = os.path.join(output_dir, "cvi42_contours")
        os.makedirs(cvi42_dir, exist_ok=True)
        parseFile(cvi42_xml, cvi42_dir)
    dataset = Biobank_Dataset(dicom_root, cvi42_dir)
    dataset.read_dicom_images()
    dataset.convert_dicom_to_nifti(output_dir)
    if cvi42_dir:
        shutil.rmtree(cvi42_dir, ignore_errors=True)


def download_and_convert(eids: Sequence[str], ukbkey: str, work_dir: str,
                         out_root: str, field_ids=(20208, 20209),
                         ukbfetch: str = "ukbfetch") -> None:
    """End-to-end batch run (``download_data_ukbb_general.py:55-110``):
    fetch → unzip → manifest sort → convert → clean."""
    for eid in eids:
        print(eid)
        subj_work = os.path.join(work_dir, str(eid))
        if not download_subject(eid, field_ids, ukbkey, subj_work, ukbfetch):
            continue
        dicom_dir = os.path.join(subj_work, "dicom")
        os.makedirs(dicom_dir, exist_ok=True)
        for z in glob.glob(os.path.join(subj_work, f"{eid}_*.zip")):
            unpack_zip(z, dicom_dir)
        sort_dicoms_by_manifest(dicom_dir)
        convert_subject(dicom_dir, os.path.join(out_root, str(eid)))
        shutil.rmtree(subj_work, ignore_errors=True)
