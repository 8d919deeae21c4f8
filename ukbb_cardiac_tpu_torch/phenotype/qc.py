"""Quality-control gate — the reference's SA runtime validator
(``cardiac_utils.py:77-136``).

It acts as a per-subject gate that *skips* bad data rather than fails,
matching the reference's defensive pipeline style, and accepts either a
filename or an in-memory array.

The port's copy of ``sa_pass_quality_control`` from
``ukbb_cardiac_tpu/phenotype/qc.py``; the LA, atrium and aorta gates
come with the slices that port their callers.
"""

from __future__ import annotations

import numpy as np

from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.ops.cc import get_largest_cc
from ukbb_cardiac_tpu_torch.phenotype.contours import lv_slice_masks


def _load_seg(seg):
    if isinstance(seg, str):
        return np.asanyarray(nifti.load(seg).dataobj), seg
    return np.asanyarray(seg), "<array>"


def sa_pass_quality_control(seg_sa) -> bool:
    """SA seg QC (``cardiac_utils.py:77-136``): every class ≥10 px; ≥6
    contiguous LV slices; LV epi + RV present on the mid-cavity slice."""
    seg_sa, name = _load_seg(seg_sa)
    if seg_sa.ndim == 4:  # full sequence passed; QC the ED frame
        seg_sa = seg_sa[:, :, :, 0]
    X, Y, Z = seg_sa.shape[:3]
    label = {"LV": 1, "Myo": 2, "RV": 3}

    for l_name, l in label.items():
        if np.sum(seg_sa == l) < 10:
            print(f"{name}: The segmentation for class {l_name} is smaller "
                  f"than 10 pixels. It does not pass the quality control.")
            return False

    z_pos = []
    for z in range(Z):
        seg_z = seg_sa[:, :, z]
        if np.sum(seg_z == label["LV"]) < 10 or np.sum(seg_z == label["Myo"]) < 10:
            continue
        z_pos.append(z)
    n_slice = len(z_pos)
    if n_slice < 6:
        print(f"{name}: The segmentation has less than 6 slices. "
              f"It does not pass the quality control.")
        return False
    if n_slice != (np.max(z_pos) - np.min(z_pos) + 1):
        print(f"{name}: There is missing segmentation between the slices. "
              f"It does not pass the quality control.")
        return False

    _, _, cz = [np.mean(v) for v in np.nonzero(seg_sa == label["LV"])]
    seg_z = seg_sa[:, :, int(round(cz))]
    endo, myo, epi = lv_slice_masks(seg_z, label["LV"], label["Myo"])
    rv = get_largest_cc(seg_z == label["RV"]).astype(np.uint8)
    if np.sum(epi) < 10 or np.sum(rv) < 10:
        print(f"{name}: Can not find LV epi or RV to determine the AHA "
              f"coordinate system.")
        return False
    return True

