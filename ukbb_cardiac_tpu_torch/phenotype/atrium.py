"""Atrial area, length and volume (area–length method).

Reference: ``common/cardiac_utils.py:1655-1736``
(``evaluate_atrial_area_length``) and ``long_axis/eval_atrial_volume.py``
(biplane volume, CSV schema, landmark VTKs).

The port's copy of ``ukbb_cardiac_tpu/phenotype/atrium.py`` (host code:
numpy and cv2).
"""

from __future__ import annotations

import math
import os
from typing import Dict

import cv2
import numpy as np
import pandas as pd

from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.io.vtkio import PolyData, save_polydata
from ukbb_cardiac_tpu_torch.ops.cc import get_largest_cc
from ukbb_cardiac_tpu_torch.phenotype.qc import atrium_pass_quality_control
from ukbb_cardiac_tpu_torch.utils.timing import span


def evaluate_atrial_area_length(label, nim, long_axis):
    """Area (cm²), length (cm) and landmark points per atrium on one
    long-axis slice (``cardiac_utils.py:1655-1736``).

    Returns ``(A, L, landmarks)`` lists ordered by ascending label id, or
    the reference's ``(-1, -1, -1)`` int sentinel on degenerate geometry
    (checked by callers via ``type(area) == int``).
    """
    pixdim = nim.header["pixdim"][1:4]
    area_per_pix = pixdim[0] * pixdim[1] * 1e-2  # cm^2

    A, L, landmarks = [], [], []
    labs = np.sort(list(set(np.unique(label)) - {0}))
    for i in labs:
        label_i = get_largest_cc(label == i)

        # Sort atrium points by distance along the long-axis
        points_label = np.nonzero(label_i)
        n_pts = len(points_label[0])
        xs, ys = points_label[0], points_label[1]
        world = (nim.affine @ np.stack(
            [xs, ys, np.zeros(n_pts), np.ones(n_pts)])).T[:, :3]
        d_long = world @ long_axis
        order = np.argsort(d_long)
        points = np.stack([xs, ys, d_long], axis=1)[order]

        # Top/bottom third centroids define the major axis
        n_points = len(points)
        top_points = points[int(2 * n_points / 3):]
        cx, cy, _ = np.mean(top_points, axis=0)
        bottom_points = points[:int(n_points / 3)]
        bx, by, _ = np.mean(bottom_points, axis=0)
        major_axis = np.array([cx - bx, cy - by])
        major_axis = major_axis / np.linalg.norm(major_axis)

        px = cx + major_axis[0] * 100
        py = cy + major_axis[1] * 100
        qx = cx - major_axis[0] * 100
        qy = cy - major_axis[1] * 100
        if np.isnan(px) or np.isnan(py) or np.isnan(qx) or np.isnan(qy):
            return -1, -1, -1

        # Rasterise the major axis and intersect with the atrium
        # (nifti index XY vs cv2 index YX, cardiac_utils.py:1706-1710)
        image_line = np.zeros(label_i.shape)
        cv2.line(image_line, (int(qy), int(qx)), (int(py), int(px)), (1, 0, 0))
        image_line = label_i & (image_line > 0)

        points_line = np.nonzero(image_line)
        m = len(points_line[0])
        if m == 0:
            return -1, -1, -1
        world_line = (nim.affine @ np.stack(
            [points_line[0], points_line[1], np.zeros(m), np.ones(m)])).T[:, :3]
        d = world_line @ long_axis
        order = np.argsort(d)
        world_line = world_line[order]
        L.append(np.linalg.norm(world_line[-1] - world_line[0]) * 1e-1)  # cm
        A.append(np.sum(label_i) * area_per_pix)
        landmarks.append(world_line[0])
        landmarks.append(world_line[-1])
    return A, L, landmarks


def _save_landmarks(landmarks, path):
    save_polydata(PolyData(points=np.asarray(landmarks, dtype=float)), path)


COLUMNS = ["LAV max (mL)", "LAV min (mL)", "LASV (mL)", "LAEF (%)",
           "RAV max (mL)", "RAV min (mL)", "RASV (mL)", "RAEF (%)"]


@span("ukbb.phenotype.atrial_volumes")
def atrial_volume_measures(data_dir: str):
    """Per-subject atrial measures (``eval_atrial_volume.py:36-163``).

    Returns the measure dict or None if inputs are missing / QC fails.
    Landmark VTKs for t=0 are written into ``data_dir`` as side effects,
    exactly like the reference.
    """
    seg_la_2ch_name = os.path.join(data_dir, "seg_la_2ch.nii.gz")
    seg_la_4ch_name = os.path.join(data_dir, "seg_la_4ch.nii.gz")
    sa_name = os.path.join(data_dir, "sa.nii.gz")
    if not (os.path.exists(seg_la_2ch_name) and os.path.exists(seg_la_4ch_name)
            and os.path.exists(sa_name)):
        return None

    nim_sa = nifti.load(sa_name)
    long_axis = nim_sa.affine[:3, 2] / np.linalg.norm(nim_sa.affine[:3, 2])
    if long_axis[2] < 0:
        long_axis *= -1

    A: Dict[str, np.ndarray] = {}
    L: Dict[str, np.ndarray] = {}
    V: Dict[str, np.ndarray] = {}

    nim_2ch = nifti.load(seg_la_2ch_name)
    seg_la_2ch = np.asanyarray(nim_2ch.dataobj)
    T = int(nim_2ch.header["dim"][4])
    if not atrium_pass_quality_control(seg_la_2ch, {"LA": 1}):
        return None

    A["LA_2ch"] = np.zeros(T)
    L["LA_2ch"] = np.zeros(T)
    V["LA_2ch"] = np.zeros(T)
    for t in range(T):
        area, length, landmarks = evaluate_atrial_area_length(
            seg_la_2ch[:, :, 0, t], nim_2ch, long_axis)
        if type(area) == int and area < 0:
            continue
        A["LA_2ch"][t] = area[0]
        L["LA_2ch"][t] = length[0]
        V["LA_2ch"][t] = 8 / (3 * math.pi) * area[0] * area[0] / length[0]
        if t == 0:
            _save_landmarks(landmarks,
                            os.path.join(data_dir, f"lm_la_2ch_{t:02d}.vtk"))

    nim_4ch = nifti.load(seg_la_4ch_name)
    seg_la_4ch = np.asanyarray(nim_4ch.dataobj)
    if not atrium_pass_quality_control(seg_la_4ch, {"LA": 1, "RA": 2}):
        return None
    if int(nim_4ch.header["dim"][4]) != T:
        # the biplane formula pairs 2ch/4ch frame-by-frame; mismatched
        # frame counts cannot be analysed — QC-style skip (the reference
        # would crash the whole dataset run here, eval_atrial_volume.py:63)
        print(f"  {data_dir}: la_2ch has {T} frames but la_4ch has "
              f"{int(nim_4ch.header['dim'][4])} — skipping subject.")
        return None

    for k in ("LA_4ch", "RA_4ch"):
        A[k] = np.zeros(T)
        L[k] = np.zeros(T)
        V[k] = np.zeros(T)
    V["LA_bip"] = np.zeros(T)
    for t in range(T):
        area, length, landmarks = evaluate_atrial_area_length(
            seg_la_4ch[:, :, 0, t], nim_4ch, long_axis)
        if type(area) == int and area < 0:
            continue
        A["LA_4ch"][t] = area[0]
        L["LA_4ch"][t] = length[0]
        V["LA_4ch"][t] = 8 / (3 * math.pi) * area[0] * area[0] / length[0]
        V["LA_bip"][t] = (8 / (3 * math.pi) * area[0] * A["LA_2ch"][t]
                          / (0.5 * (length[0] + L["LA_2ch"][t])))
        A["RA_4ch"][t] = area[1]
        L["RA_4ch"][t] = length[1]
        V["RA_4ch"][t] = 8 / (3 * math.pi) * area[1] * area[1] / length[1]
        if t == 0:
            _save_landmarks(landmarks,
                            os.path.join(data_dir, f"lm_la_4ch_{t:02d}.vtk"))

    # NaN-safe EFs: if every frame hit the (-1,-1,-1) sentinel the volume
    # curves are all-zero — emit NaN instead of a 0/0 RuntimeWarning
    nan = np.float64("nan")
    val = {}
    val["LAV_bip_max"] = np.max(V["LA_bip"])
    val["LAV_bip_min"] = np.min(V["LA_bip"])
    val["LASV_bip"] = val["LAV_bip_max"] - val["LAV_bip_min"]
    val["LAEF_bip"] = (val["LASV_bip"] / val["LAV_bip_max"] * 100
                       if val["LAV_bip_max"] > 0 else nan)
    val["RAV_4ch_max"] = np.max(V["RA_4ch"])
    val["RAV_4ch_min"] = np.min(V["RA_4ch"])
    val["RASV_4ch"] = val["RAV_4ch_max"] - val["RAV_4ch_min"]
    val["RAEF_4ch"] = (val["RASV_4ch"] / val["RAV_4ch_max"] * 100
                       if val["RAV_4ch_max"] > 0 else nan)
    return val


def evaluate_atrial_volume_dataset(data_dir: str, output_csv: str) -> pd.DataFrame:
    """Dataset driver with the reference's CSV schema
    (``eval_atrial_volume.py:165-168``)."""
    table, processed = [], []
    for data in sorted(os.listdir(data_dir)):
        subject_dir = os.path.join(data_dir, data)
        if not os.path.isdir(subject_dir):
            continue
        val = atrial_volume_measures(subject_dir)
        if val is None:
            continue
        print(data)
        table.append([val["LAV_bip_max"], val["LAV_bip_min"], val["LASV_bip"],
                      val["LAEF_bip"], val["RAV_4ch_max"], val["RAV_4ch_min"],
                      val["RASV_4ch"], val["RAEF_4ch"]])
        processed.append(data)
    df = pd.DataFrame(table, index=processed, columns=COLUMNS)
    df.to_csv(output_csv)
    return df
