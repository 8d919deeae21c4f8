"""Myocardial contour extraction for strain analysis (short-axis).

Reference: ``common/cardiac_utils.py:549-752`` (``extract_myocardial_contour``).
Per selected slice: smoothed epicardial + endocardial contours in world
coordinates, circumferential line cells along each contour, ~36 radial
endo→epi line cells aligned with the radial direction, point arrays
(Label 1=endo / 2=epi, Segment_ID, Direction_Radial) and cell arrays
(Segment_ID, Direction_ID: 1=radial, 2=circumferential, 3=longitudinal).

The port's copy of ``ukbb_cardiac_tpu/phenotype/myo_contour.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.spatial import cKDTree

from benchmark.reference.port.io import nifti
from benchmark.reference.port.io.vtkio import PolyData, save_polydata
from benchmark.reference.port.phenotype import aha
from benchmark.reference.port.phenotype.contours import (approximate_contour,
    contour_to_world, extract_contour, lv_slice_masks)

DIR_RADIAL, DIR_CIRCUM, DIR_LONGIT = 1, 2, 3


def extract_myocardial_contour(seg_name: str, contour_name_stem: str,
                               part: Optional[str] = None,
                               three_slices: bool = False) -> None:
    """Write per-slice ED contour polydata ``<stem><z:02d>.vtk``
    (``cardiac_utils.py:549-752``)."""
    nim = nifti.load(seg_name)
    Z = int(nim.header["dim"][3])
    affine = nim.affine
    seg = np.asanyarray(nim.dataobj)
    if seg.ndim == 4:
        seg = seg[:, :, :, 0]
    label = aha.SA_LABEL

    aha_axis = aha.determine_aha_coordinate_system(seg, affine)
    if not part:
        part_z = aha.determine_aha_part(seg, affine, three_slices=three_slices)
    else:
        part_z = {z: part for z in range(Z)}

    for z in range(Z):
        seg_z = seg[:, :, z]
        endo, myo, epi = lv_slice_masks(seg_z, label["LV"], label["Myo"])
        if np.sum(endo) < 10 or np.sum(myo) < 10:
            continue
        if z not in part_z:
            continue

        cx, cy = [np.mean(v) for v in np.nonzero(endo)]
        lv_centre = np.dot(affine, np.array([cx, cy, z, 1]))[:3]


        epi_contour = approximate_contour(extract_contour(epi), periodic=True)
        endo_contour = approximate_contour(extract_contour(endo), periodic=True)
        epi_world = contour_to_world(epi_contour, z, affine)
        endo_world = contour_to_world(endo_contour, z, affine)

        def radial_dirs(pts):
            d = pts - lv_centre[None, :]
            return d / np.linalg.norm(d, axis=1, keepdims=True)

        epi_rad = radial_dirs(epi_world)
        endo_rad = radial_dirs(endo_world)
        epi_ids = aha.determine_aha_segment_ids(epi_world, lv_centre, aha_axis,
                                                part_z[z])
        endo_ids = aha.determine_aha_segment_ids(endo_world, lv_centre,
                                                 aha_axis, part_z[z])

        n_epi, n_endo = len(epi_world), len(endo_world)
        points = np.concatenate([epi_world, endo_world], axis=0)
        pt_label = np.concatenate([np.full(n_epi, 2), np.full(n_endo, 1)])
        pt_ids = np.concatenate([epi_ids, endo_ids]).astype(np.int32)
        pt_radial = np.concatenate([epi_rad, endo_rad], axis=0)

        lines, lines_aha, lines_dir = [], [], []
        # circumferential cells: epi then endo (reference order :645-708)
        for i in range(n_epi):
            lines.append(np.array([i, (i + 1) % n_epi]))
            lines_aha.append(epi_ids[i])
            lines_dir.append(DIR_CIRCUM)
        for i in range(n_endo):
            lines.append(np.array([n_epi + i, n_epi + (i + 1) % n_endo]))
            lines_aha.append(endo_ids[i])
            lines_dir.append(DIR_CIRCUM)

        # radial cells: every ~N/36-th endo point to the epi point whose
        # radial direction best aligns, among its 10 nearest epi points
        # (cardiac_utils.py:710-733)
        tree = cKDTree(epi_world)
        n_radial = 36
        M = int(round(n_endo / float(n_radial)))
        M = max(M, 1)
        for i in range(n_endo):
            if i % M != 0:
                continue
            p = endo_world[i]
            d_rad = endo_rad[i]
            n_ids = min(10, n_epi)
            _, idx = tree.query(p, k=n_ids)
            idx = np.atleast_1d(idx)
            q = epi_world[idx]
            dirs = q - lv_centre[None, :]
            dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
            best = idx[int(np.argmax(dirs @ d_rad))]
            lines.append(np.array([n_epi + i, best]))
            lines_aha.append(endo_ids[i])
            lines_dir.append(DIR_RADIAL)

        poly = PolyData(
            points=points,
            lines=lines,
            point_scalars={"Label": pt_label.astype(np.int32),
                           "Segment_ID": pt_ids},
            point_vectors={"Direction_Radial": pt_radial},
            cell_scalars={"Segment_ID": np.asarray(lines_aha, np.int32),
                          "Direction_ID": np.asarray(lines_dir, np.int32)},
        )
        save_polydata(poly, f"{contour_name_stem}{z:02d}.vtk")
