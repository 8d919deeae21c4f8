"""Aortic cross-sectional areas and distensibility.

The port's copy of ``ukbb_cardiac_tpu/phenotype/aorta.py`` (reference:
``aortic/eval_aortic_area.py``).  Central pulse pressure comes from the
Vicorder fields ``12678-2.0/2.1`` of the UK Biobank blood-pressure
spreadsheet (a CSV with a two-row header).
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.phenotype.qc import aorta_pass_quality_control
from ukbb_cardiac_tpu_torch.utils.timing import span

COLUMNS = ["AAo max area (mm2)", "AAo min area (mm2)",
           "AAo distensibility (10-3 mmHg-1)",
           "DAo max area (mm2)", "DAo min area (mm2)",
           "DAo distensibility (10-3 mmHg-1)"]


def load_central_pulse_pressure(pressure_csv: str) -> pd.Series:
    """Mean of the Vicorder central-pulse-pressure instances, values
    < 10 mmHg discarded (``eval_aortic_area.py:40-44``)."""
    df_info = pd.read_csv(pressure_csv, header=[0, 1], index_col=0)
    central_pp = df_info["Central pulse pressure during PWA"][
        ["12678-2.0", "12678-2.1"]].mean(axis=1)
    central_pp[central_pp < 10] = np.nan
    return central_pp


@span("ukbb.phenotype.aortic_areas")
def aortic_area_measures(data_dir: str, central_pp_value: float):
    """Per-subject AAo/DAo max/min area + distensibility
    (``eval_aortic_area.py:58-83``). Returns dict or None."""
    image_name = os.path.join(data_dir, "ao.nii.gz")
    seg_name = os.path.join(data_dir, "seg_ao.nii.gz")
    if not (os.path.exists(image_name) and os.path.exists(seg_name)):
        return None

    nim = nifti.load(image_name)
    dx, dy = nim.header["pixdim"][1:3]
    area_per_pixel = dx * dy
    image = np.asanyarray(nim.dataobj)
    seg = np.asanyarray(nifti.load(seg_name).dataobj)

    if not aorta_pass_quality_control(image, seg):
        return None

    val = {}
    for l_name, l in [("AAo", 1), ("DAo", 2)]:
        A = np.sum(seg == l, axis=(0, 1, 2)) * area_per_pixel
        # NaN-safe: a zero minimum area (degenerate seg that slipped past
        # QC) or a missing/zero pulse pressure yields NaN, not a warning
        denom = A.min() * central_pp_value
        val[l_name] = {
            "max area": A.max(),
            "min area": A.min(),
            "distensibility": ((A.max() - A.min()) / denom * 1e3
                               if denom > 0 else np.float64("nan")),
        }
    return val


def aortic_row(val) -> list:
    """The six values of one subject's table row, in :data:`COLUMNS`
    order."""
    return [val[v][k] for v in ("AAo", "DAo")
            for k in ("max area", "min area", "distensibility")]


def evaluate_aortic_area_dataset(data_dir: str, pressure_csv: str,
                                 output_csv: str) -> pd.DataFrame:
    """Dataset driver with the reference CSV schema
    (``eval_aortic_area.py:86-90``)."""
    central_pp = load_central_pulse_pressure(pressure_csv)
    table, processed = [], []
    for data in sorted(os.listdir(data_dir)):
        subject_dir = os.path.join(data_dir, data)
        if not os.path.isdir(subject_dir):
            continue
        try:
            pp = central_pp.loc[int(data)]
        except (KeyError, ValueError):
            pp = np.nan
        val = aortic_area_measures(subject_dir, pp)
        if val is None:
            continue
        print(data)
        table.append(aortic_row(val))
        processed.append(data)
    df = pd.DataFrame(table, index=processed, columns=COLUMNS)
    df.to_csv(output_csv)
    return df
