"""Long-axis (4-chamber) motion tracking and longitudinal strain.

Reference: ``common/cardiac_utils.py:990-1136`` (mitral-valve trimming,
LA AHA-6 partitioning), ``:1139-1322`` (``extract_la_myocardial_contour``),
``:1325-1404`` (``evaluate_la_strain_by_length``) and ``:1407-1537``
(``cine_2d_la_motion_and_strain_analysis``).

Counterpart of ``ukbb_cardiac_tpu/phenotype/strain_la.py``.  The host
stages (mitral-valve cut, LA AHA parts from the SA stack, contour
extraction, the strain table) are copies.  The motion engine is the SA
driver's: one batched FFD registration of the slice's frame pairs on the
card (``reg.make_register_batch``), densify, inversion, composition and
blending there, and the contour points sampled and the warp-Dice scored
there too (``phenotype/strain.py``); only point displacements and Dice
rows come back to the host.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch

from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.io.vtkio import (PolyData, load_polydata,
                                             save_polydata)
from ukbb_cardiac_tpu_torch.ops.crop import foreground_bbox
from ukbb_cardiac_tpu_torch.phenotype.aha import \
    determine_aha_coordinate_system
from ukbb_cardiac_tpu_torch.phenotype.contours import (approximate_contour,
                                                       extract_contour,
                                                       lv_slice_masks)
from ukbb_cardiac_tpu_torch.parallel.mesh import resolve_device_for
from ukbb_cardiac_tpu_torch.phenotype.strain import (bucket_hw,
                                                     bucket_points,
                                                     sample_points,
                                                     track_slice_fields,
                                                     warp_dice)
from ukbb_cardiac_tpu_torch.reg.register import RegConfig

LA_LABEL = {"BG": 0, "LV": 1, "Myo": 2, "RV": 3, "LA": 4, "RA": 5}


def remove_mitral_valve_points(endo_contour, epi_contour, mitral_plane):
    """Cut both contours at the mitral-valve plane so they become open
    curves starting just after the plane (``cardiac_utils.py:990-1032``)."""

    def trim(contour):
        N = contour.shape[0]
        start_i = 0
        for i in range(N):
            y, x = contour[i]
            prev_y, prev_x = contour[(i - 1) % N]
            if not mitral_plane[x, y] and mitral_plane[prev_x, prev_y]:
                start_i = i
                break
        contour = np.concatenate((contour[start_i:], contour[:start_i]))
        N = contour.shape[0]
        end_i = N
        for i in range(N):
            y, x = contour[i]
            if mitral_plane[x, y]:
                end_i = i
                break
        return contour[:end_i]

    return trim(endo_contour), trim(epi_contour)


def determine_la_aha_part(seg_la, affine_la, affine_sa):
    """Long-axis index (2x granularity of SA slice index) → basal/mid/
    apical thirds + LV mid-line per index (``cardiac_utils.py:1035-1103``)."""
    label = LA_LABEL
    inv_sa = np.linalg.inv(affine_sa)
    z = 0

    def la_indices(mask):
        xs, ys = np.nonzero(mask)
        n = len(xs)
        vox = np.stack([xs, ys, np.zeros(n), np.ones(n)])
        z_sa = (inv_sa @ (affine_la @ vox))[2]
        return xs, ys, np.rint(z_sa * 2).astype(int)

    lv_myo = (seg_la == label["LV"]) | (seg_la == label["Myo"])
    _, _, lv_myo_idx = la_indices(lv_myo)
    lv_myo_idx_min, lv_myo_idx_max = lv_myo_idx.min(), lv_myo_idx.max()

    if affine_sa[2, 2] > 0:
        la_idx = np.arange(lv_myo_idx_max, lv_myo_idx_min, -1)
    else:
        la_idx = np.arange(lv_myo_idx_min, lv_myo_idx_max + 1, 1)

    n_la_idx = len(la_idx)
    i1 = int(math.ceil(n_la_idx / 3.0))
    i2 = int(math.ceil(2 * n_la_idx / 3.0))
    part_z: Dict[int, str] = {}
    for i in range(0, i1):
        part_z[la_idx[i]] = "basal"
    for i in range(i1, i2):
        part_z[la_idx[i]] = "mid"
    for i in range(i2, n_la_idx):
        part_z[la_idx[i]] = "apical"

    xs, ys, lv_idx = la_indices(seg_la == label["LV"])
    lv_idx_min, lv_idx_max = lv_idx.min(), lv_idx.max()
    mid_line: Dict[int, np.ndarray] = {}
    for idx in range(lv_idx_min, lv_idx_max + 1):
        sel = lv_idx == idx
        mx, my = np.mean(xs[sel]), np.mean(ys[sel])
        mid_line[idx] = np.dot(affine_la, np.array([mx, my, z, 1]))[:3]
    for idx in range(lv_myo_idx_min, lv_idx_min):
        mid_line[idx] = mid_line[lv_idx_min]
    for idx in range(lv_idx_max, lv_myo_idx_max + 1):
        mid_line[idx] = mid_line[lv_idx_max]
    return part_z, mid_line


def determine_la_aha_segment_id(point, la_idx, axis, mid_line, part_z) -> int:
    """Septal vs lateral (sign of dot with lv_to_sep) x part → LA-6
    segment ID (``cardiac_utils.py:1106-1136``)."""
    vec = point - mid_line[la_idx]
    septal = np.dot(vec, axis["lv_to_sep"]) > 0
    part = part_z[la_idx]
    table = {("basal", True): 1, ("basal", False): 2,
             ("mid", True): 3, ("mid", False): 4,
             ("apical", True): 5, ("apical", False): 6}
    return table[(part, bool(septal))]


def extract_la_myocardial_contour(seg_la_name: str, seg_sa_name: str,
                                  contour_name: str) -> None:
    """4ch ED endo/epi open contours with longitudinal line cells and
    AHA-6 labels (``cardiac_utils.py:1139-1322``)."""
    nim = nifti.load(seg_la_name)
    affine = nim.affine
    seg = np.asanyarray(nim.dataobj)
    if seg.ndim == 4:
        seg = seg[:, :, :, 0]
    label = LA_LABEL

    nim_sa = nifti.load(seg_sa_name)
    affine_sa = nim_sa.affine
    seg_sa = np.asanyarray(nim_sa.dataobj)
    if seg_sa.ndim == 4:
        seg_sa = seg_sa[:, :, :, 0]
    aha_axis = determine_aha_coordinate_system(seg_sa, affine_sa)

    z = 0
    seg_z = seg[:, :, z]
    # lv_slice_masks keeps all non-small myocardium CCs — the myocardium
    # may be split at the thin apex (cardiac_utils.py:1180-1184)
    endo, myo, epi = lv_slice_masks(seg_z, label["LV"], label["Myo"])

    endo_contour = extract_contour(endo)
    epi_contour = extract_contour(epi)

    mitral_plane = np.zeros(seg_z.shape)
    for y, x in epi_contour:
        if endo[x, y]:
            mitral_plane[x, y] = 1
    if np.sum(mitral_plane) >= 1:
        endo_contour, epi_contour = remove_mitral_valve_points(
            endo_contour, epi_contour, mitral_plane)

    if len(endo_contour) >= 2:
        endo_contour = approximate_contour(endo_contour)
    if len(epi_contour) >= 2:
        epi_contour = approximate_contour(epi_contour)

    part_z, mid_line = determine_la_aha_part(seg_z, affine, affine_sa)
    la_idx_min = min(part_z.keys())
    la_idx_max = max(part_z.keys())
    inv_sa = np.linalg.inv(affine_sa)

    points, pt_label, pt_ids, pt_radial = [], [], [], []
    lines, lines_aha, lines_dir = [], [], []

    for contour, lab in ((endo_contour, 1), (epi_contour, 2)):
        base = len(points)
        N = contour.shape[0]
        for i in range(N):
            y, x = contour[i]
            p = np.dot(affine, np.array([x, y, z, 1]))[:3]
            z_sa = np.dot(inv_sa, np.hstack([p, 1]))[2]
            la_idx = int(round(z_sa * 2))
            la_idx = min(max(la_idx, la_idx_min), la_idx_max)
            d = p - mid_line[la_idx]
            d = d / np.linalg.norm(d)
            seg_id = determine_la_aha_segment_id(p, la_idx, aha_axis,
                                                 mid_line, part_z)
            points.append(p)
            pt_label.append(lab)
            pt_ids.append(seg_id)
            pt_radial.append(d)
            if i < N - 1:
                lines.append(np.array([base + i, base + i + 1]))
                lines_aha.append(seg_id)
                lines_dir.append(3)  # longitudinal

    poly = PolyData(
        points=np.asarray(points),
        lines=lines,
        point_scalars={"Label": np.asarray(pt_label, np.int32),
                       "Segment_ID": np.asarray(pt_ids, np.int32)},
        point_vectors={"Direction_Radial": np.asarray(pt_radial)},
        cell_scalars={"Segment_ID": np.asarray(lines_aha, np.int32),
                      "Direction_ID": np.asarray(lines_dir, np.int32)},
    )
    save_polydata(poly, contour_name)


def evaluate_la_strain_by_length(contour_name_stem: str, T: int, dt: float,
                                 output_name_stem: str, polys=None,
                                 write_vtk: bool = True) -> None:
    """Longitudinal strain table, 7 rows (6 segments + Global)
    (``cardiac_utils.py:1325-1404``).  ``polys``: optional in-memory
    per-frame polydata (skips reloading the files
    :func:`finish_la_motion` just wrote); the Strain-annotated files are
    still written unless ``write_vtk=False``."""
    poly_ED = (polys[0] if polys is not None
               else load_polydata(f"{contour_name_stem}{0:02d}.vtk"))
    pts = poly_ED.points
    lines_arr = np.asarray(poly_ED.lines)
    length_ED = np.linalg.norm(pts[lines_arr[:, 0]] - pts[lines_arr[:, 1]],
                               axis=1)
    seg_id = poly_ED.cell_scalars["Segment_ID"]
    dir_id = poly_ED.cell_scalars["Direction_ID"]

    table = np.zeros((7, T))
    for fr in range(T):
        filename = f"{contour_name_stem}{fr:02d}.vtk"
        poly = polys[fr] if polys is not None else load_polydata(filename)
        p = poly.points
        d = np.linalg.norm(p[lines_arr[:, 0]] - p[lines_arr[:, 1]], axis=1)
        strain = (d - length_ED) / length_ED * 100
        poly.cell_scalars["Strain"] = strain
        if write_vtk:
            save_polydata(poly, filename)
        for i in range(6):
            sel = (seg_id == (i + 1)) & (dir_id == 3)
            table[i, fr] = np.mean(strain[sel]) if np.any(sel) else np.nan
        table[-1, fr] = np.mean(strain[dir_id == 3])

    index = [str(x) for x in np.arange(1, 7)] + ["Global"]
    column = np.arange(0, T) * dt * 1e3
    pd.DataFrame(table, index=index, columns=column).to_csv(
        f"{output_name_stem}_longit.csv")


def start_la_motion_dispatch(data_dir: str, output_dir: str,
                             cfg: RegConfig = RegConfig(),
                             register_batch=None, mesh=None,
                             eval_dice: bool = False, device=None):
    """Stage 1 of the LA strain driver: crop, ED contour, and the
    registration + composition queued on the device.  Returns a context
    for :func:`finish_la_motion` (its point displacements and Dice rows
    are device tensors, possibly still being computed).  Runs on
    ``device`` (default the card; raises without one unless
    ``device="cpu"``; with a ``mesh``, its first device).
    ``register_batch``: a prebuilt (possibly mesh-split) registration for
    this subject's crop, which is then not padded to the bucket;
    ``mesh``: split the pair population over the mesh."""
    dev = resolve_device_for(device, mesh)
    # LV-focused crop via relabelling (cardiac_utils.py:1412-1425):
    # Myo->LV, then RV/LA/RA -> BG, bbox + 20; the crop shares the source
    # grid, so it is an exact slice in memory
    ed_nim = nifti.load(os.path.join(data_dir, "seg4_la_4ch_ED.nii.gz"))
    seg_ed = np.asanyarray(ed_nim.dataobj)
    if seg_ed.ndim == 4:
        seg_ed = seg_ed[:, :, :, 0]
    lv_ed = np.array(seg_ed)
    lv_ed[lv_ed == 2] = 1                        # Myo -> LV
    for lab in (3, 4, 5):
        lv_ed[lv_ed == lab] = 0
    x1, x2, y1, y2, z1, z2 = foreground_bbox(lv_ed, 20)

    la_nim = nifti.load(os.path.join(data_dir, "la_4ch.nii.gz"))
    la_full = np.asanyarray(la_nim.dataobj)
    if la_full.ndim == 3:
        la_full = la_full[..., None]
    affine_crop = np.copy(la_nim.affine)
    affine_crop[:3, 3] = (affine_crop @ np.array([x1, y1, z1, 1.0]))[:3]
    la_crop = la_full[x1:x2, y1:y2, z1:z2].astype(np.float32)
    seg4_full = np.asanyarray(
        nifti.load(os.path.join(data_dir, "seg4_la_4ch.nii.gz")).dataobj)
    if seg4_full.ndim == 3:
        seg4_full = seg4_full[..., None]
    seg_crop = seg4_full[x1:x2, y1:y2, z1:z2]

    extract_la_myocardial_contour(
        os.path.join(data_dir, "seg4_la_4ch_ED.nii.gz"),
        os.path.join(data_dir, "seg_sa_ED.nii.gz"),
        os.path.join(output_dir, "la_4ch_myo_contour_ED.vtk"))

    T = la_crop.shape[3]
    dt = float(la_nim.header["pixdim"][4])
    inv_affine = np.linalg.inv(affine_crop)
    X, Y = la_crop.shape[:2]

    frames = np.transpose(la_crop[:, :, 0, :], (2, 0, 1))
    # zero-pad to the JAX package's LA bucket, a multiple of 64 (coarser
    # than the SA path's 32): the reference solves the padded problem (a
    # prebuilt registration has the shape its caller chose)
    Xp, Yp = (X, Y) if register_batch is not None else bucket_hw(X, Y, 64)
    frames = np.pad(frames, ((0, 0), (0, Xp - X), (0, Yp - Y)))

    # the contour points (and labels) go up before the registration is
    # queued: a host-to-device copy waits for the stream
    poly_ED = load_polydata(os.path.join(output_dir,
                                         "la_4ch_myo_contour_ED.vtk"))
    world = poly_ED.points
    vox = (inv_affine @ np.concatenate(
        [world, np.ones((len(world), 1))], axis=1).T).T[:, :3]
    pts = np.zeros((1, bucket_points(len(vox)), 2), np.float32)
    pts[0, :len(vox)] = vox[:, :2]
    pts_dev = torch.from_numpy(pts).to(dev)
    seg_dev = None
    if eval_dice:
        seg_sel = np.transpose(seg_crop[:, :, 0, :],
                               (2, 0, 1))[None].astype(np.int32)
        seg_sel = np.pad(seg_sel, ((0, 0), (0, 0), (0, Xp - X), (0, Yp - Y)))
        seg_dev = torch.from_numpy(seg_sel).to(dev)

    # the dense fields stay on the device; only points and Dice rows return
    fields = track_slice_fields(frames, cfg, register_batch, mesh,
                                device=dev)
    with torch.no_grad():
        disp = sample_points(fields, pts_dev)
        dice = None if seg_dev is None else warp_dice(seg_dev, fields, X, Y)
    return {"output_dir": output_dir, "disp_dev": disp,
            "dice_dev": dice, "poly_ED": poly_ED, "vox": vox, "T": T,
            "dt": dt, "X": X, "Y": Y, "affine_crop": affine_crop,
            "inv_affine": inv_affine}


def finish_la_motion(ctx: dict, output_name_stem: str,
                     eval_dice: bool = False,
                     write_artifacts: bool = True) -> Optional[pd.DataFrame]:
    """Stage 2 of the LA strain driver: fetch the point displacements,
    move the ED contour through them and write the strain table
    (``cardiac_utils.py:1496-1537``).  ``write_artifacts=False`` skips the
    per-frame contour VTKs (the cohort driver deletes the motion
    directory right after reading the CSV)."""
    output_dir = ctx["output_dir"]
    T, dt = ctx["T"], ctx["dt"]
    affine_crop = ctx["affine_crop"]
    disp = ctx["disp_dev"].cpu().numpy().astype(np.float32)[0]  # (T, N, 2)
    poly_ED = ctx["poly_ED"]
    vox = ctx["vox"]

    frame_polys = []
    for fr in range(T):
        vox_fr = vox.copy()
        vox_fr[:, :2] += disp[fr, :len(vox)]
        world_fr = (affine_crop @ np.concatenate(
            [vox_fr, np.ones((len(vox_fr), 1))], axis=1).T).T[:, :3]
        poly_fr = PolyData(points=world_fr, lines=list(poly_ED.lines),
                           point_scalars=dict(poly_ED.point_scalars),
                           point_vectors=dict(poly_ED.point_vectors),
                           cell_scalars=dict(poly_ED.cell_scalars))
        if write_artifacts:
            save_polydata(poly_fr, os.path.join(
                output_dir, f"la_4ch_myo_contour_fr{fr:02d}.vtk"))
        frame_polys.append(poly_fr)

    evaluate_la_strain_by_length(
        os.path.join(output_dir, "la_4ch_myo_contour_fr"), T, dt,
        output_name_stem, polys=frame_polys, write_vtk=write_artifacts)

    if eval_dice and ctx["dice_dev"] is not None:
        df = pd.DataFrame(ctx["dice_dev"].cpu().numpy().astype(
            np.float32).reshape(-1, 2))
        df.to_csv(os.path.join(output_dir, "dice_cine_la_4ch_warp_ffd.csv"),
                  index=None, header=None)
        return df
    return None


def cine_2d_la_motion_and_strain_analysis(data_dir: str, output_dir: str,
                                          output_name_stem: str,
                                          cfg: RegConfig = RegConfig(),
                                          eval_dice: bool = False,
                                          register_batch=None, mesh=None,
                                          device=None
                                          ) -> Optional[pd.DataFrame]:
    """Full LA strain driver (``cardiac_utils.py:1407-1537``), MIRTK-free.

    Expects ``<data_dir>/{la_4ch,seg4_la_4ch,seg4_la_4ch_ED,seg_sa_ED}.nii.gz``.
    ``register_batch``: an optional prebuilt (possibly mesh-split)
    registration for this subject's crop; ``mesh``: split the pair
    population over a mesh.  Composed from
    :func:`start_la_motion_dispatch` + :func:`finish_la_motion`.
    """
    ctx = start_la_motion_dispatch(data_dir, output_dir, cfg,
                                   register_batch, mesh,
                                   eval_dice=eval_dice, device=device)
    return finish_la_motion(ctx, output_name_stem, eval_dice)
