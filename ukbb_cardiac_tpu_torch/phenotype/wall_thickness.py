"""Myocardial wall thickness per AHA segment.

Reference: ``common/cardiac_utils.py:358-546`` (``evaluate_wall_thickness``).

Differences from the reference are purely mechanical:
- nearest-epicardial-point search uses a cKDTree over the epi contour
  (same nearest neighbour as ``vtkPointLocator``, ``:441-459``)
- VTK output uses our pure-python legacy writer (``io/vtkio.py``)
- segment IDs are assigned vectorised over the whole contour
Outputs are identical in format: ``<stem>.vtk``, ``<stem>_epi.vtk``,
``<stem>.csv`` (mean), ``<stem>_max.csv`` — 17 rows (1..16 + Global).

The port's copy of ``ukbb_cardiac_tpu/phenotype/wall_thickness.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
from scipy.spatial import cKDTree

from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.io.vtkio import PolyData, save_polydata
from ukbb_cardiac_tpu_torch.phenotype import aha
from ukbb_cardiac_tpu_torch.phenotype.contours import (approximate_contour,
    contour_to_world, extract_contour, lv_slice_masks)
from ukbb_cardiac_tpu_torch.utils.timing import span


@span("ukbb.phenotype.wall_thickness")
def evaluate_wall_thickness(seg_name: str, output_name_stem: str,
                            part: Optional[str] = None,
                            save_epi_contour: bool = True) -> None:
    """Per-slice endo/epi contours → per-point thickness → per-AHA-segment
    mean and max tables (``cardiac_utils.py:358-546``)."""
    nim = nifti.load(seg_name)
    Z = int(nim.header["dim"][3])
    affine = nim.affine
    seg = np.asanyarray(nim.dataobj)
    if seg.ndim == 4:
        seg = seg[:, :, :, 0]
    label = aha.SA_LABEL

    aha_axis = aha.determine_aha_coordinate_system(seg, affine)
    if not part:
        part_z = aha.determine_aha_part(seg, affine)
    else:
        part_z = {z: part for z in range(Z)}

    endo_pts, endo_thick, endo_ids, endo_lines = [], [], [], []
    epi_pts, epi_ids, epi_lines = [], [], []

    for z in range(Z):
        seg_z = seg[:, :, z]
        endo, myo, epi = lv_slice_masks(seg_z, label["LV"], label["Myo"])
        if np.sum(endo) < 10 or np.sum(myo) < 10:
            continue
        if z not in part_z:
            continue

        cx, cy = [np.mean(v) for v in np.nonzero(endo)]
        lv_centre = np.dot(affine, np.array([cx, cy, z, 1]))[:3]

        endo_contour = extract_contour(endo)
        epi_contour = extract_contour(epi)
        if len(endo_contour) == 0 or len(epi_contour) == 0:
            continue
        endo_contour = approximate_contour(endo_contour, periodic=True)
        epi_contour = approximate_contour(epi_contour, periodic=True)

        endo_world = contour_to_world(endo_contour, z, affine)
        epi_world = contour_to_world(epi_contour, z, affine)

        # nearest epicardial point for every endo point
        tree = cKDTree(epi_world)
        dist, _ = tree.query(endo_world)

        ids = aha.determine_aha_segment_ids(endo_world, lv_centre, aha_axis,
                                            part_z[z])
        base = sum(len(p) for p in endo_pts)
        n = len(endo_world)
        endo_pts.append(endo_world)
        endo_thick.append(dist)
        endo_ids.append(ids)
        for i in range(n):
            endo_lines.append(np.array([base + i, base + (i + 1) % n]))

        if save_epi_contour:
            ids_epi = aha.determine_aha_segment_ids(epi_world, lv_centre,
                                                    aha_axis, part_z[z])
            base_e = sum(len(p) for p in epi_pts)
            m = len(epi_world)
            epi_pts.append(epi_world)
            epi_ids.append(ids_epi)
            for i in range(m):
                epi_lines.append(np.array([base_e + i, base_e + (i + 1) % m]))

    if not endo_pts:
        raise ValueError(f"{seg_name}: no usable slice for wall thickness")

    np_thickness = np.concatenate(endo_thick)
    np_points_aha = np.concatenate(endo_ids)
    endo_poly = PolyData(points=np.concatenate(endo_pts, axis=0),
                         lines=endo_lines,
                         point_scalars={"Thickness": np_thickness,
                                        "Segment_ID": np_points_aha})
    save_polydata(endo_poly, f"{output_name_stem}.vtk")

    if save_epi_contour and epi_pts:
        epi_poly = PolyData(points=np.concatenate(epi_pts, axis=0),
                            lines=epi_lines,
                            point_scalars={"Segment_ID": np.concatenate(epi_ids)})
        save_polydata(epi_poly, f"{output_name_stem}_epi.vtk")

    # Per-segment tables (cardiac_utils.py:529-546)
    table_thickness = np.zeros(17)
    table_thickness_max = np.zeros(17)
    for i in range(16):
        sel = np_points_aha == (i + 1)
        table_thickness[i] = np.mean(np_thickness[sel]) if np.any(sel) else np.nan
        table_thickness_max[i] = np.max(np_thickness[sel]) if np.any(sel) else np.nan
    table_thickness[-1] = np.mean(np_thickness)
    table_thickness_max[-1] = np.max(np_thickness)

    index = [str(x) for x in np.arange(1, 17)] + ["Global"]
    with span("ukbb.io.csv"):
        pd.DataFrame(table_thickness, index=index,
                     columns=["Thickness"]).to_csv(f"{output_name_stem}.csv")
        pd.DataFrame(table_thickness_max, index=index,
                     columns=["Thickness_Max"]).to_csv(
                         f"{output_name_stem}_max.csv")
