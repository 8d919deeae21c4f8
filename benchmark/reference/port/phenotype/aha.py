"""AHA 17-segment coordinate system and slice partitioning.

Reference: ``common/cardiac_utils.py:172-355``
(``determine_aha_coordinate_system``, ``determine_aha_part``,
``determine_aha_segment_id``).

The port's copy of ``ukbb_cardiac_tpu/phenotype/aha.py``.
"""

from __future__ import annotations

import math
from typing import Dict

import cv2
import numpy as np

from benchmark.reference.port.ops.cc import get_largest_cc
from benchmark.reference.port.phenotype.contours import extract_contour, lv_slice_masks

SA_LABEL = {"BG": 0, "LV": 1, "Myo": 2, "RV": 3}


def _mid_cavity_masks(seg_sa: np.ndarray):
    """Clean masks on the mid-cavity slice (``cardiac_utils.py:179-191``)."""
    _, _, cz = [np.mean(x) for x in np.nonzero(seg_sa == SA_LABEL["LV"])]
    z = int(round(cz))
    seg_z = seg_sa[:, :, z]
    endo, myo, epi = lv_slice_masks(seg_z, SA_LABEL["LV"], SA_LABEL["Myo"])
    rv = get_largest_cc(seg_z == SA_LABEL["RV"]).astype(np.uint8)
    return z, endo, myo, epi, rv


def determine_aha_coordinate_system(seg_sa: np.ndarray,
                                    affine_sa: np.ndarray) -> Dict[str, np.ndarray]:
    """AHA axes from the mid-cavity slice (``cardiac_utils.py:172-226``):
    ``lv_to_sep`` towards the septum (RV-dilation ∩ LV-epi contour),
    ``apex_to_base`` = affine z column (made z-positive),
    ``inf_to_ant`` = their cross product."""
    z, endo, myo, epi, rv = _mid_cavity_masks(seg_sa)
    epi_contour = extract_contour(epi)

    septum = []
    dilate_iter = 1
    while len(septum) == 0:
        rv_dilate = cv2.dilate(rv, np.ones((3, 3), dtype=np.uint8),
                               iterations=dilate_iter)
        dilate_iter += 1
        for y, x in epi_contour:
            if rv_dilate[x, y] == 1:
                septum.append([x, y])
        if dilate_iter > 64:
            raise ValueError("RV never intersects LV epicardium")

    mx, my = septum[int(round(0.5 * len(septum)))]
    point_septum = np.dot(affine_sa, np.array([mx, my, z, 1]))[:3]

    cx, cy = [np.mean(v) for v in np.nonzero(endo)]
    point_cavity = np.dot(affine_sa, np.array([cx, cy, z, 1]))[:3]

    axis = {}
    axis["lv_to_sep"] = point_septum - point_cavity
    axis["lv_to_sep"] /= np.linalg.norm(axis["lv_to_sep"])
    axis["apex_to_base"] = np.copy(affine_sa[:3, 2])
    axis["apex_to_base"] /= np.linalg.norm(axis["apex_to_base"])
    if axis["apex_to_base"][2] < 0:
        axis["apex_to_base"] *= -1
    axis["inf_to_ant"] = np.cross(axis["apex_to_base"], axis["lv_to_sep"])
    return axis


def determine_aha_part(seg_sa: np.ndarray, affine_sa: np.ndarray,
                       three_slices: bool = False) -> Dict[int, str]:
    """Map slice index → {'basal','mid','apical'}
    (``cardiac_utils.py:229-293``).  ``three_slices`` picks the 25/50/75%
    representative slices used for strain analysis."""
    X, Y, Z = seg_sa.shape[:3]
    z_pos = []
    for z in range(Z):
        seg_z = seg_sa[:, :, z]
        endo = seg_z == SA_LABEL["LV"]
        myo = seg_z == SA_LABEL["Myo"]
        if np.sum(endo) < 10 or np.sum(myo) < 10:
            continue
        z_pos.append((z, np.dot(affine_sa, np.array([X / 2.0, Y / 2.0, z, 1]))[2]))
    z_pos = sorted(z_pos, key=lambda v: -v[1])  # base (high z) first

    n_slice = len(z_pos)
    part_z: Dict[int, str] = {}
    if three_slices:
        part_z[z_pos[int(round((n_slice - 1) * 0.25))][0]] = "basal"
        part_z[z_pos[int(round((n_slice - 1) * 0.5))][0]] = "mid"
        part_z[z_pos[int(round((n_slice - 1) * 0.75))][0]] = "apical"
    else:
        i1 = int(math.ceil(n_slice / 3.0))
        i2 = int(math.ceil(2 * n_slice / 3.0))
        for i in range(0, i1):
            part_z[z_pos[i][0]] = "basal"
        for i in range(i1, i2):
            part_z[z_pos[i][0]] = "mid"
        for i in range(i2, n_slice):
            part_z[z_pos[i][0]] = "apical"
    return part_z


_SECTOR_BOUNDS_6 = [(-30, 30), (30, 90), (90, 150), None, (-150, -90), (-90, -30)]


def determine_aha_segment_id(point: np.ndarray, lv_centre: np.ndarray,
                             aha_axis: Dict[str, np.ndarray], part: str) -> int:
    """Angle of (point − LV centre) in the AHA in-plane axes → segment ID
    (``cardiac_utils.py:296-355``): basal 1-6, mid 7-12, apical 13-16,
    apex 17."""
    d = point - lv_centre
    x = np.dot(d, aha_axis["inf_to_ant"])
    y = np.dot(d, aha_axis["lv_to_sep"])
    deg = math.degrees(math.atan2(y, x))

    if part == "basal" or part == "mid":
        base = 1 if part == "basal" else 7
        for i, bounds in enumerate(_SECTOR_BOUNDS_6):
            if bounds is None:  # the wrap-around sector (>=150 or < -150)
                if deg >= 150 or deg < -150:
                    return base + i
            elif bounds[0] <= deg < bounds[1]:
                return base + i
        raise ValueError(f"wrong degree {deg}")
    if part == "apical":
        if -45 <= deg < 45:
            return 13
        if 45 <= deg < 135:
            return 14
        if deg >= 135 or deg < -135:
            return 15
        if -135 <= deg < -45:
            return 16
        raise ValueError(f"wrong degree {deg}")
    if part == "apex":
        return 17
    raise ValueError(f"unknown part {part}")


def determine_aha_segment_ids(points: np.ndarray, lv_centre: np.ndarray,
                              aha_axis: Dict[str, np.ndarray],
                              part: str) -> np.ndarray:
    """Vectorised segment IDs for an (N, 3) point array — the per-contour
    hot path, done in one shot instead of the reference's per-point loop."""
    d = points - lv_centre[None, :]
    x = d @ aha_axis["inf_to_ant"]
    y = d @ aha_axis["lv_to_sep"]
    deg = np.degrees(np.arctan2(y, x))
    ids = np.zeros(len(points), dtype=np.int32)
    if part in ("basal", "mid"):
        base = 1 if part == "basal" else 7
        sectors = np.floor((deg + 30.0) / 60.0).astype(int) % 6  # 0..5
        # sector 0: [-30,30) -> id base; 1: [30,90) -> base+1; ...
        ids = base + sectors
    elif part == "apical":
        sectors = np.floor((deg + 45.0) / 90.0).astype(int) % 4
        ids = 13 + sectors
    elif part == "apex":
        ids[:] = 17
    else:
        raise ValueError(f"unknown part {part}")
    return ids
