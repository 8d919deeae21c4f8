"""The cohort's measure stages, written out plainly from the published
scripts rather than copied from the program: the ventricular volume row
(``short_axis/eval_ventricular_volume.py``) and the aortic area row
(``aortic/eval_aortic_area.py``) of ``baiwenjia/ukbb_cardiac``.

Each takes labels and the cine's NIfTI header, counts voxels, and keeps
the scripts' arithmetic in their order (the voxel volume is the product
of the header's float32 spacings), so that a correct program's row
equals this one exactly.  The aortic row first applies the aortic
quality control of the frozen copy (``port/phenotype/qc.py``).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.port.phenotype.qc import aorta_pass_quality_control

MYOCARDIAL_DENSITY = 1.05   # g/mL


def volume_row(labels: np.ndarray, header) -> dict:
    """LV and RV volumes (mL), LV mass (g), stroke volumes, ejection
    fractions (%) and cardiac outputs (L/min) of SA labels (X, Y, Z, T):
    ED is frame 0, ES the frame of least LV cavity."""
    pixdim = header["pixdim"]
    ml_per_voxel = pixdim[1] * pixdim[2] * pixdim[3] * 1e-3
    cycle_s = header["dim"][4] * pixdim[4]
    beats_per_min = 60.0 / cycle_s if cycle_s > 0 else np.float64("nan")
    counts = {label: np.sum(labels == label, axis=(0, 1, 2))
              for label in (1, 2, 3)}
    frames = {"ED": 0, "ES": int(np.argmin(counts[1] * ml_per_voxel))}
    row = {}
    for name, t in frames.items():
        row[f"LV{name}V"] = np.float64(counts[1][t] * ml_per_voxel)
        row[f"LV{name}M"] = np.float64(counts[2][t] * ml_per_voxel
                                       * MYOCARDIAL_DENSITY)
        row[f"RV{name}V"] = np.float64(counts[3][t] * ml_per_voxel)
    for v in ("LV", "RV"):
        row[f"{v}SV"] = row[f"{v}EDV"] - row[f"{v}ESV"]
        row[f"{v}CO"] = row[f"{v}SV"] * beats_per_min * 1e-3
        row[f"{v}EF"] = (row[f"{v}SV"] / row[f"{v}EDV"] * 100
                         if row[f"{v}EDV"] > 0 else np.float64("nan"))
    return row


def area_row(image: np.ndarray, labels: np.ndarray, header,
             pulse_pressure: float):
    """Ascending (label 1) and descending (label 2) aortic maximum and
    minimum areas (mm^2) and distensibility (10^-3 / mmHg) of an aortic
    cine (X, Y, 1, T), keyed as the cohort's row (``"AAo max area"``, ...),
    or None where the labels fail the aortic quality control."""
    if not aorta_pass_quality_control(image, labels):
        return None
    mm2_per_pixel = header["pixdim"][1] * header["pixdim"][2]
    row = {}
    for vessel, label in (("AAo", 1), ("DAo", 2)):
        area = np.sum(labels == label, axis=(0, 1, 2)) * mm2_per_pixel
        most, least = area.max(), area.min()
        denom = least * pulse_pressure
        row[f"{vessel} max area"] = most
        row[f"{vessel} min area"] = least
        row[f"{vessel} distensibility"] = ((most - least) / denom * 1e3
                                           if denom > 0
                                           else np.float64("nan"))
    return row
