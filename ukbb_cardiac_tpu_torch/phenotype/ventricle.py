"""Ventricular volumes and derived clinical measures.

Reference: ``short_axis/eval_ventricular_volume.py`` (whole file).
The port's copy of ``ukbb_cardiac_tpu/phenotype/ventricle.py`` (numpy
only), over the port's own NIfTI reader.
The per-subject computation is exposed as a function so the CLI
(``cli/eval_ventricular_volume.py``) is a thin wrapper; volumes are plain
voxel-count reductions — vectorised over all frames at once.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import pandas as pd

from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.utils.timing import span

DENSITY = 1.05  # myocardium g/mL (eval_ventricular_volume.py:44)

COLUMNS = ["LVEDV (mL)", "LVESV (mL)", "LVSV (mL)", "LVEF (%)", "LVCO (L/min)",
           "LVM (g)", "RVEDV (mL)", "RVESV (mL)", "RVSV (mL)", "RVEF (%)"]


def ventricular_volume_measures(image_name: str, seg_name: str) -> Optional[Dict[str, float]]:
    """Clinical LV/RV measures for one subject
    (``eval_ventricular_volume.py:40-74``). Returns None if files missing."""
    if not (os.path.exists(image_name) and os.path.exists(seg_name)):
        return None
    nim = nifti.load(image_name)
    seg = np.asanyarray(nifti.load(seg_name).dataobj)
    return ventricular_volume_measures_from_seg(seg, nim.header)


@span("ukbb.phenotype.volumes")
def ventricular_volume_measures_from_seg(seg: np.ndarray,
                                         header) -> Dict[str, float]:
    """Array-based core of :func:`ventricular_volume_measures` — lets
    pipelines (``parallel/cohort.py``) compute volumes from the
    segmentation still in memory instead of re-reading the file they
    just wrote.  ``header`` is the cine's NIfTI header (pixdim/dim)."""
    pixdim = header["pixdim"][1:4]
    volume_per_pix = pixdim[0] * pixdim[1] * pixdim[2] * 1e-3  # mL

    duration_per_cycle = header["dim"][4] * header["pixdim"][4]
    heart_rate = (60.0 / duration_per_cycle if duration_per_cycle > 0
                  else np.float64("nan"))

    frame = {"ED": 0}
    vol_t = np.sum(seg == 1, axis=(0, 1, 2)) * volume_per_pix
    frame["ES"] = int(np.argmin(vol_t))

    val: Dict[str, float] = {}
    for fr_name, fr in frame.items():
        val[f"LV{fr_name}V"] = np.float64(np.sum(seg[:, :, :, fr] == 1) * volume_per_pix)
        val[f"LV{fr_name}M"] = np.float64(np.sum(seg[:, :, :, fr] == 2) * volume_per_pix * DENSITY)
        val[f"RV{fr_name}V"] = np.float64(np.sum(seg[:, :, :, fr] == 3) * volume_per_pix)

    # degenerate segmentations (empty LV/RV at ED) produce NaN measures
    # instead of a RuntimeWarning-laden inf — QC-style skip, the caller
    # still gets a row it can filter (reference gates these upstream via
    # sa_pass_quality_control; the function itself must stay NaN-safe)
    nan = np.float64("nan")
    val["LVSV"] = val["LVEDV"] - val["LVESV"]
    val["LVCO"] = val["LVSV"] * heart_rate * 1e-3
    val["LVEF"] = (val["LVSV"] / val["LVEDV"] * 100
                   if val["LVEDV"] > 0 else nan)
    val["RVSV"] = val["RVEDV"] - val["RVESV"]
    val["RVCO"] = val["RVSV"] * heart_rate * 1e-3
    val["RVEF"] = (val["RVSV"] / val["RVEDV"] * 100
                   if val["RVEDV"] > 0 else nan)
    return val


def evaluate_ventricular_volume_dataset(data_dir: str, output_csv: str) -> pd.DataFrame:
    """Walk subject dirs, compute measures, write the CSV with the
    reference's exact column schema (``eval_ventricular_volume.py:78-81``)."""
    table, processed = [], []
    for data in sorted(os.listdir(data_dir)):
        subject_dir = os.path.join(data_dir, data)
        val = ventricular_volume_measures(
            os.path.join(subject_dir, "sa.nii.gz"),
            os.path.join(subject_dir, "seg_sa.nii.gz"))
        if val is None:
            continue
        print(data)
        table.append([val["LVEDV"], val["LVESV"], val["LVSV"], val["LVEF"],
                      val["LVCO"], val["LVEDM"], val["RVEDV"], val["RVESV"],
                      val["RVSV"], val["RVEF"]])
        processed.append(data)
    df = pd.DataFrame(table, index=processed, columns=COLUMNS)
    df.to_csv(output_csv)
    return df
