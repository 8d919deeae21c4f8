"""Quality-control gates — the reference's runtime validators
(``cardiac_utils.py:77-169,1616-1652,1739-1796``).

They act as per-subject gates that *skip* bad data rather than fail,
matching the reference's defensive pipeline style; the SA and LA gates
accept either a filename or an in-memory array.

The port's copy of ``ukbb_cardiac_tpu/phenotype/qc.py``.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.port.io import nifti
from benchmark.reference.port.ops.cc import count_significant_cc, get_largest_cc
from benchmark.reference.port.phenotype.contours import lv_slice_masks


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


def aorta_pass_quality_control(image, seg) -> bool:
    """Aorta QC (``cardiac_utils.py:1739-1796``): per vessel —
    (1) area > 0 at all frames; (2) max intensity in the structure at any
    frame < 3x its ED mean intensity; (3) ≤1 connected component >10 px
    (8-connectivity); (4) no ≥2x / ≤0.5x frame-to-frame area change;
    (5) max/min area ratio < 2."""
    image = np.asanyarray(image)
    seg = np.asanyarray(seg)
    T = seg.shape[3]
    for l_name, l in [("AAo", 1), ("DAo", 2)]:
        for t in range(T):
            if np.sum(seg[:, :, :, t] == l) == 0:
                print(f"The area of {l_name} is 0 at time frame {t}.")
                return False

        mean_intensity_ED = image[:, :, :, 0][seg[:, :, :, 0] == l].mean()
        for t in range(T):
            max_intensity_t = np.max(image[:, :, :, t][seg[:, :, :, t] == l])
            if max_intensity_t / mean_intensity_ED >= 3:
                print(f"The image becomes very noisy at time frame {t}.")
                return False

        for t in range(T):
            if count_significant_cc(seg[:, :, :, t] == l, 10, 2) >= 2:
                print(f"The segmentation has at least two connected "
                      f"components with more than 10 pixels at time frame {t}.")
                return False

        A = np.sum(seg == l, axis=(0, 1, 2))
        for t in range(T):
            ratio = A[t] / float(A[t - 1])
            if ratio >= 2 or ratio <= 0.5:
                print(f"There is abrupt change of area at time frame {t}.")
                return False

        if np.max(A) / np.min(A) >= 2:
            print("There is large change of area between maximum and "
                  "minimum areas.")
            return False
    return True
