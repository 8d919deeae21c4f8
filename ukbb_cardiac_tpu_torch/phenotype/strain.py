"""Short-axis motion tracking and strain analysis.

Counterpart of ``ukbb_cardiac_tpu/phenotype/strain.py`` (reference:
``common/cardiac_utils.py:755-987``).  The whole (slice, frame-pair)
population of a subject is ONE batched registration on the card
(``reg.make_register_batch``); densify, inversion, composition and
blending of the motion fields run there too, as one CUDA graph per
shape (``reg/programs.py``), and so do the contour points' sampling and
the warp-Dice; only the contour-point displacements and the warp-Dice
rows come back to the host:

  pairs (3 slices x T, or 3 x 2(T-1) in both directions)
  →  batched FFD register
  → per-slice forward/backward composition (dense-field compose)
  → time-weighted forward/backward blending (the ``average_3d_ffd`` sum)
  → ED contour points pushed through the per-frame fields
  → Lagrangian strain per line = (len_t − len_ED)/len_ED x 100
  → 17x(T) radial + circumferential CSV tables.

Where the JAX package ``vmap``-s over slices, the slice axis is a batch
dimension here.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Optional

import numpy as np
import pandas as pd
import torch

from ukbb_cardiac_tpu_torch.parallel.mesh import resolve_device_for
from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.io.vtkio import (PolyData, append_polydata,
                                             load_polydata, save_polydata)
from ukbb_cardiac_tpu_torch.ops.crop import foreground_bbox
from ukbb_cardiac_tpu_torch.phenotype.myo_contour import \
    extract_myocardial_contour
from ukbb_cardiac_tpu_torch.reg import programs
from ukbb_cardiac_tpu_torch.reg.register import (RegConfig, compose_chain,
                                                 invert_field_batch,
                                                 make_register_batch,
                                                 total_field)
from ukbb_cardiac_tpu_torch.utils.timing import span


def evaluate_strain_by_length(contour_name_stem: str, T: int, dt: float,
                              output_name_stem: str, polys=None,
                              write_vtk: bool = True) -> None:
    """Lagrangian strain per line cell vs ED; per-AHA-segment tables
    (``cardiac_utils.py:755-837``).  Reads ``<stem><fr:02d>.vtk`` (or the
    same polydata passed in memory via ``polys``), writes the Strain cell
    array back and ``<out>_radial.csv`` / ``<out>_circum.csv``.
    ``write_vtk=False`` skips rewriting the Strain-annotated frame files
    (the cohort driver deletes the motion directory right after)."""
    poly_ED = (polys[0] if polys is not None
               else load_polydata(f"{contour_name_stem}{0:02d}.vtk"))
    pts = poly_ED.points
    lines_arr = np.asarray(poly_ED.lines)
    length_ED = np.linalg.norm(pts[lines_arr[:, 0]] - pts[lines_arr[:, 1]],
                               axis=1)
    seg_id = poly_ED.cell_scalars["Segment_ID"]
    dir_id = poly_ED.cell_scalars["Direction_ID"]

    table_strain = {"radial": np.zeros((17, T)), "circum": np.zeros((17, T))}
    for fr in range(T):
        filename = f"{contour_name_stem}{fr:02d}.vtk"
        poly = polys[fr] if polys is not None else load_polydata(filename)
        p = poly.points
        d = np.linalg.norm(p[lines_arr[:, 0]] - p[lines_arr[:, 1]], axis=1)
        strain = (d - length_ED) / length_ED * 100
        poly.cell_scalars["Strain"] = strain
        if write_vtk:
            save_polydata(poly, filename)

        for i in range(16):
            table_strain["radial"][i, fr] = np.mean(
                strain[(seg_id == (i + 1)) & (dir_id == 1)]) if np.any(
                    (seg_id == (i + 1)) & (dir_id == 1)) else np.nan
            table_strain["circum"][i, fr] = np.mean(
                strain[(seg_id == (i + 1)) & (dir_id == 2)]) if np.any(
                    (seg_id == (i + 1)) & (dir_id == 2)) else np.nan
        table_strain["radial"][-1, fr] = np.mean(strain[dir_id == 1])
        table_strain["circum"][-1, fr] = np.mean(strain[dir_id == 2])

    for c in ("radial", "circum"):
        index = [str(x) for x in np.arange(1, 17)] + ["Global"]
        column = np.arange(0, T) * dt * 1e3  # time in ms
        df = pd.DataFrame(table_strain[c], index=index, columns=column)
        with span("ukbb.io.csv"):
            df.to_csv(f"{output_name_stem}_{c}.csv")


_HW_BUCKET = 32


def bucket_hw(X: int, Y: int, bucket: int = _HW_BUCKET):
    """Round a crop's in-plane shape up to the JAX package's compile-shape
    bucket (a multiple of 32).  Eager PyTorch compiles nothing per shape,
    but the reference solves the zero-padded problem, so the port pads the
    same way to give the same numbers."""
    return (-(-X // bucket) * bucket, -(-Y // bucket) * bucket)


def combine_fields(fields: torch.Tensor, Z: int, T: int,
                   inverse_consistent: bool = True) -> torch.Tensor:
    """Per-slice forward/backward composition and blending of the dense
    pair fields → ED→fr fields (Z, T, X, Y, 2) (``cardiac_utils.py:881-936``;
    the JAX ``_field_programs`` combine).

    ``fields`` holds per slice the T-1 forward pairs (fr-1 → fr), then
    the backward chain's pairs: with ``inverse_consistent`` the wrap pair
    0 → T-1 alone ((Z * T, X, Y, 2); the pairs (fr+1 → fr) are the
    forward pairs inverted), else the T-1 registered pairs
    ((fr+1) % T → fr for fr = T-1 .. 1; (Z * 2(T-1), X, Y, 2)).  On the
    card a CUDA graph per (device, Z, T, X, Y, inverse_consistent),
    captured at its first call and replayed (``reg/programs.py``)."""
    return programs.run(
        ("combine-fields", Z, T, inverse_consistent),
        lambda f: (_combine(f, Z, T, inverse_consistent),), fields)[0]


def _field_program(controls, image_shape, Z: int, T: int, cfg: RegConfig,
                   inverse_consistent: bool = True) -> torch.Tensor:
    """The registration's per-level lattices → ED→fr fields (Z, T, X, Y,
    2): densify (:func:`total_field`) + :func:`combine_fields` in one
    program per (device, Z, T, X, Y, cfg, inverse_consistent), the JAX
    ``_field_programs`` pair."""
    image_shape = tuple(image_shape)

    def program(*cs):
        return (_combine(total_field(cs, image_shape, cfg), Z, T,
                         inverse_consistent),)

    return programs.run(("motion-fields", Z, T, image_shape, cfg,
                         inverse_consistent), program, *controls)[0]


def _combine(fields: torch.Tensor, Z: int, T: int,
             inverse_consistent: bool) -> torch.Tensor:
    """:func:`combine_fields` as eager ops."""
    X, Y = fields.shape[1:3]
    per = T if inverse_consistent else 2 * (T - 1)
    per_slice = fields.reshape(Z, per, X, Y, 2)
    fwd_pairs = per_slice[:, :T - 1]            # entry fr-1 maps fr-1 -> fr
    if inverse_consistent:
        wraps = per_slice[:, T - 1]             # 0 -> T-1 per slice
        # backward chain pairs: (0->T-1), then (fr+1->fr) = inverse of the
        # forward pair (fr->fr+1), fr = T-2 .. 1, all slices in one batch
        inv_in = torch.flip(fwd_pairs[:, 1:], dims=(1,)).reshape(
            Z * (T - 2), X, Y, 2)
        inv = invert_field_batch(inv_in).reshape(Z, T - 2, X, Y, 2)
        bwd_pairs = torch.cat([wraps[:, None], inv], dim=1)
    else:
        bwd_pairs = per_slice[:, T - 1:]
    forward = compose_chain(fwd_pairs)
    backward_rev = compose_chain(bwd_pairs)
    backward = torch.cat([backward_rev[:, :1],
                          torch.flip(backward_rev[:, 1:], dims=(1,))], dim=1)
    ar = torch.arange(T, device=fields.device)
    wf = ((T - ar) / T).reshape(T, 1, 1, 1)
    wb = (ar / T).reshape(T, 1, 1, 1)
    out = wf * forward + wb * backward
    out[:, 0] = 0.0
    return out


def pair_frames(frames_zs: np.ndarray, inverse_consistent: bool = True):
    """The registration's (targets, sources), (B, X, Y) each, in the
    layout :func:`combine_fields` reads: per slice the forward pairs
    fr-1 → fr, then the wrap pair 0 → T-1 alone (``inverse_consistent``:
    B = Z * T) or the backward pairs (fr+1) % T → fr for fr = T-1 .. 1
    (B = Z * 2(T-1))."""
    T = frames_zs.shape[1]
    back = [T - 1] if inverse_consistent else list(range(T - 1, 0, -1))
    targets = np.concatenate([np.concatenate(
        [f[:-1], f[[(fr + 1) % T for fr in back]]]) for f in frames_zs])
    sources = np.concatenate([np.concatenate([f[1:], f[back]])
                              for f in frames_zs])
    return targets, sources


# contour points per slice are padded to a multiple of this (the JAX
# package's _PTS_BUCKET), so that subjects share the sampling program
_PTS_BUCKET = 128


def sample_points(fields: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear, edge-clamped sampling of (Zsel, T, X, Y, 2) fields at
    (Zsel, N, 2) voxel coordinates → (Zsel, T, N, 2) (the JAX
    ``_sample_program``; on the card a CUDA graph per (Zsel, T, X, Y, N),
    ``reg/programs.py``)."""
    return programs.run(("sample-points",), _sample_points, fields, pts)[0]


def _sample_points(fields: torch.Tensor, pts: torch.Tensor):
    Zsel, T, X, Y, _ = fields.shape
    x = torch.clamp(pts[..., 0], 0.0, X - 1.0)            # (Zsel, N)
    y = torch.clamp(pts[..., 1], 0.0, Y - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None, :, None]                       # (Zsel, 1, N, 1)
    fy = (y - y0)[:, None, :, None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=X - 1)
    y1i = torch.clamp(y0i + 1, max=Y - 1)
    z = torch.arange(Zsel, device=fields.device)[:, None]  # (Zsel, 1)

    def corner(xi, yi):                                   # → (Zsel, T, N, 2)
        return fields[z, :, xi, yi].permute(0, 2, 1, 3)

    f00, f01 = corner(x0i, y0i), corner(x0i, y1i)
    f10, f11 = corner(x1i, y0i), corner(x1i, y1i)
    return (f00 * (1 - fx) * (1 - fy) + f01 * (1 - fx) * fy
            + f10 * fx * (1 - fy) + f11 * fx * fy,)


def warp_dice(seg: torch.Tensor, fields: torch.Tensor, xv: int,
              yv: int) -> torch.Tensor:
    """Warp every frame's labels to ED and score LV/Myo Dice against the
    ED labels (the reference's dormant self-check,
    ``cardiac_utils.py:944-967``; the JAX ``_warp_dice_program``): labels
    (Zsel, T, X, Y) + fields (Zsel, T, X, Y, 2) → (Zsel, T, 2).  Nearest
    neighbour is ``floor(c + 0.5)``, outside the image reads 0, and warped
    labels outside the valid (pre-bucket-padding) region (xv, yv) are
    masked to background.

    On the card a CUDA graph per (Zsel, T, X, Y) (``reg/programs.py``):
    the valid region goes in as a tensor, as the JAX program takes it as
    runtime scalars, so that subjects whose crops differ by a few pixels
    share the program; it goes up from pinned memory without waiting for
    the stream (the registration may still be running)."""
    region = torch.tensor([xv, yv], dtype=torch.float32)
    if seg.device.type == "cuda":
        region = region.pin_memory().to(seg.device, non_blocking=True)
    return programs.run(("warp-dice",), _warp_dice, seg, fields, region)[0]


def _warp_dice(seg: torch.Tensor, fields: torch.Tensor,
               region: torch.Tensor):
    Zsel, T, X, Y = seg.shape
    gx, gy = torch.meshgrid(
        torch.arange(X, dtype=torch.float32, device=seg.device),
        torch.arange(Y, dtype=torch.float32, device=seg.device),
        indexing="ij")
    valid = (gx < region[0]) & (gy < region[1])
    xi = torch.floor(gx + fields[..., 0] + 0.5).long()
    yi = torch.floor(gy + fields[..., 1] + 0.5).long()
    inb = (xi >= 0) & (xi < X) & (yi >= 0) & (yi < Y) & valid
    n = Zsel * T
    boff = (torch.arange(n, device=seg.device) * (X * Y)).reshape(
        Zsel, T, 1, 1)
    v = seg.reshape(-1)[boff + xi.clamp(0, X - 1) * Y + yi.clamp(0, Y - 1)]
    warped = torch.where(inb, v, torch.zeros_like(v))
    ed = seg[:, :1]

    def dice(k):
        a = (ed == k).float()
        b = (warped == k).float()
        return 2 * torch.sum(a * b, dim=(-2, -1)) / (
            torch.sum(a, dim=(-2, -1)) + torch.sum(b, dim=(-2, -1)))

    return (torch.stack([dice(1), dice(2)], dim=-1),)


def bucket_points(n: int) -> int:
    """``n`` contour points (at least 1) rounded up to the bucket."""
    return -(-max(n, 1) // _PTS_BUCKET) * _PTS_BUCKET


def track_multi_slice_fields(frames_zs: np.ndarray, cfg: RegConfig,
                             register_batch=None, device=None,
                             inverse_consistent: bool = True,
                             mesh=None) -> torch.Tensor:
    """Per-frame ED→fr displacement fields for several slices at once.

    frames_zs: (Z, T, X, Y).  Returns the (Z, T, X, Y, 2) tensor on the
    device: forward = compose of pairs (fr-1→fr); backward = compose of
    circular pairs (fr+1→fr) from frame 0 backwards; blended with weights
    (T−fr)/T and fr/T (``cardiac_utils.py:881-936``).  Every slice's every
    pair joins ONE batched registration.  ``inverse_consistent`` (the
    default): each adjacent pair is registered once and the reverse
    transform comes from field inversion; False: the reference's
    both-directions scheme, every backward pair registered too (2(T-1)
    pairs a slice against T).  ``register_batch``: a
    prebuilt :func:`make_register_batch` for (X, Y).  ``mesh``: split the
    pair population over the mesh (:func:`make_register_batch`); the
    fields then land on its first device unless ``device`` is given.
    """
    dev = resolve_device_for(device, mesh)
    Z, T, X, Y = frames_zs.shape
    if register_batch is None:
        register_batch = make_register_batch((X, Y), cfg, mesh=mesh,
                                             device=dev)
    targets, sources = pair_frames(frames_zs, inverse_consistent)
    controls = register_batch(torch.from_numpy(targets).to(dev),
                              torch.from_numpy(sources).to(dev))
    controls = tuple(c.to(dev) for c in controls)
    with torch.no_grad():
        return _field_program(controls, (X, Y), Z, T, cfg,
                              inverse_consistent)


def track_slice_fields(frames: np.ndarray, cfg: RegConfig,
                       register_batch=None, mesh=None,
                       device=None) -> torch.Tensor:
    """Single-slice wrapper around :func:`track_multi_slice_fields`:
    frames (T, X, Y) → (1, T, X, Y, 2) on the device (the slice axis kept,
    as :func:`sample_points` and :func:`warp_dice` take it)."""
    return track_multi_slice_fields(frames[None], cfg, register_batch,
                                    device=device, mesh=mesh)


def start_sa_motion_dispatch(data_dir: str, output_dir: str,
                             cfg: RegConfig = RegConfig(),
                             eval_dice: bool = False,
                             register_batch=None, mesh=None, device=None,
                             inverse_consistent: bool = True):
    """Stage 1 of the SA strain driver: crop, ED contours, and the whole
    registration + composition queued on the device.

    Returns a context for :func:`finish_sa_motion` (its point
    displacements and Dice rows are device tensors, possibly still being
    computed), or None when no slice qualifies.  Runs on ``device``
    (default the card; raises without one unless ``device="cpu"``; with a
    ``mesh``, its first device).  ``inverse_consistent``: see
    :func:`track_multi_slice_fields`.  ``register_batch``: a prebuilt
    (possibly mesh-split) registration for this subject's LV crop, which
    is then not padded to the bucket; ``mesh``: split the pair population
    over the mesh.

    Spans (``utils/timing.py``): ``ukbb.phenotype.strain.crop``,
    ``ukbb.phenotype.strain.contours`` and ``ukbb.reg.dispatch`` (the
    registration, field and sampling programs queued).
    """
    dev = resolve_device_for(device, mesh)
    with span("ukbb.phenotype.strain.crop"):
        # LV-focused crop (cardiac_utils.py:845-853): relabel RV->BG,
        # bbox+20; the crop shares the source grid, so it is an exact
        # slice in memory
        ed_nim = nifti.load(os.path.join(data_dir, "seg_sa_ED.nii.gz"))
        seg_ed = np.asanyarray(ed_nim.dataobj)
        if seg_ed.ndim == 4:
            seg_ed = seg_ed[:, :, :, 0]
        lv_ed = np.array(seg_ed)
        lv_ed[lv_ed == 3] = 0                        # padding(..., 3, 0)
        x1, x2, y1, y2, z1, z2 = foreground_bbox(lv_ed, 20)

        sa_nim = nifti.load(os.path.join(data_dir, "sa.nii.gz"))
        sa_full = np.asanyarray(sa_nim.dataobj)
        if sa_full.ndim == 3:
            sa_full = sa_full[..., None]
        affine_crop = np.copy(sa_nim.affine)
        affine_crop[:3, 3] = (affine_crop @ np.array([x1, y1, z1, 1.0]))[:3]
        sa_crop = sa_full[x1:x2, y1:y2, z1:z2].astype(np.float32)
        seg_full = np.asanyarray(
            nifti.load(os.path.join(data_dir, "seg_sa.nii.gz")).dataobj)
        if seg_full.ndim == 3:
            seg_full = seg_full[..., None]
        seg_crop = seg_full[x1:x2, y1:y2, z1:z2]

    with span("ukbb.phenotype.strain.contours"):
        # ED contours on the three representative slices (basal/mid/
        # apical); stale contour files of another subject would be
        # trusted below
        for stale in _glob.glob(os.path.join(output_dir,
                                             "myo_contour_ED_z*.vtk")):
            os.remove(stale)
        extract_myocardial_contour(
            os.path.join(data_dir, "seg_sa_ED.nii.gz"),
            os.path.join(output_dir, "myo_contour_ED_z"), three_slices=True)

    Z = sa_crop.shape[2]
    T = sa_crop.shape[3]
    dt = float(sa_nim.header["pixdim"][4])
    inv_affine = np.linalg.inv(affine_crop)
    X, Y = sa_crop.shape[:2]

    selected = [z for z in range(Z) if os.path.exists(
        os.path.join(output_dir, f"myo_contour_ED_z{z:02d}.vtk"))]
    if not selected:
        return None
    with span("ukbb.phenotype.strain.crop"):
        frames_zs = np.stack([np.transpose(sa_crop[:, :, z, :], (2, 0, 1))
                              for z in selected])  # (Zsel, T, X, Y)
        # zero-pad to the bucket: the reference solves the padded problem
        # (a prebuilt registration has the shape its caller chose)
        Xp, Yp = (X, Y) if register_batch is not None else bucket_hw(X, Y)
        frames_zs = np.pad(frames_zs, ((0, 0), (0, 0), (0, Xp - X),
                                       (0, Yp - Y)))

    with span("ukbb.phenotype.strain.contours"):
        # the contour points (and labels) go up before the registration
        # is queued: a host-to-device copy waits for the stream, and this
        # function returns with the registration still running on the card
        polys_ED, voxs = [], []
        for z in selected:
            poly = load_polydata(
                os.path.join(output_dir, f"myo_contour_ED_z{z:02d}.vtk"))
            world = poly.points
            voxs.append((inv_affine @ np.concatenate(
                [world, np.ones((len(world), 1))], axis=1).T).T[:, :3])
            polys_ED.append(poly)
        pts = np.zeros((len(selected),
                        bucket_points(max(len(v) for v in voxs)), 2),
                       np.float32)
        for i, v in enumerate(voxs):
            pts[i, :len(v)] = v[:, :2]
        pts_dev = torch.from_numpy(pts).to(dev)
    seg_dev = None
    if eval_dice:
        with span("ukbb.phenotype.strain.crop"):
            seg_sel = np.stack([np.transpose(seg_crop[:, :, z, :],
                                             (2, 0, 1))
                                for z in selected]).astype(np.int32)
            seg_sel = np.pad(seg_sel, ((0, 0), (0, 0), (0, Xp - X),
                                       (0, Yp - Y)))
            seg_dev = torch.from_numpy(seg_sel).to(dev)

    # the dense fields stay on the device; only points and Dice rows return
    with span("ukbb.reg.dispatch"):
        fields = track_multi_slice_fields(
            frames_zs, cfg, register_batch, device=dev,
            inverse_consistent=inverse_consistent, mesh=mesh)
        with torch.no_grad():
            disp = sample_points(fields, pts_dev)
            dice = (None if seg_dev is None
                    else warp_dice(seg_dev, fields, X, Y))
    return {"output_dir": output_dir, "selected": selected,
            "disp_dev": disp, "dice_dev": dice,
            "polys_ED": polys_ED, "voxs": voxs,
            "T": T, "dt": dt, "X": X, "Y": Y,
            "Z": Z, "affine_crop": affine_crop, "inv_affine": inv_affine,
            "eval_dice": eval_dice}


def finish_sa_motion(ctx: dict, output_name_stem: str,
                     write_artifacts: bool = True) -> Optional[pd.DataFrame]:
    """Stage 2 of the SA strain driver: fetch the contour-point
    displacements (and the warp-Dice rows), build and write the per-frame
    contour polydata and write the strain tables
    (``cardiac_utils.py:938-987``).  ``write_artifacts=False`` skips the
    per-frame contour VTKs (the cohort driver deletes the motion
    directory right after reading the CSVs).  Spans
    (``utils/timing.py``): ``ukbb.phenotype.strain.fetch``, the wait for
    the card and the readback, and ``ukbb.phenotype.strain.tables``."""
    with span("ukbb.phenotype.strain.fetch"):
        disp_zs = ctx["disp_dev"].cpu().numpy().astype(np.float32)
        dice_rows = []
        if ctx["eval_dice"] and ctx["dice_dev"] is not None:
            # rows come back (Zsel, T, 2), in (slice, frame) order
            dice_rows = list(ctx["dice_dev"].cpu().numpy().astype(
                np.float32).reshape(-1, 2))
    with span("ukbb.phenotype.strain.tables"):
        output_dir = ctx["output_dir"]
        selected = ctx["selected"]
        T, dt = ctx["T"], ctx["dt"]
        affine_crop = ctx["affine_crop"]
        eval_dice = ctx["eval_dice"]
        polys_by_frame = [[] for _ in range(T)]

        for zi, z in enumerate(selected):
            poly_ED = ctx["polys_ED"][zi]
            vox = ctx["voxs"][zi]

            for fr in range(T):
                vox_fr = vox.copy()
                vox_fr[:, :2] += disp_zs[zi, fr, :len(vox)]
                world_fr = (affine_crop @ np.concatenate(
                    [vox_fr, np.ones((len(vox_fr), 1))], axis=1).T).T[:, :3]
                poly_fr = PolyData(points=world_fr, lines=list(poly_ED.lines),
                                   point_scalars=dict(poly_ED.point_scalars),
                                   point_vectors=dict(poly_ED.point_vectors),
                                   cell_scalars=dict(poly_ED.cell_scalars))
                if write_artifacts:
                    save_polydata(
                        poly_fr,
                        os.path.join(output_dir,
                                     f"myo_contour_z{z:02d}_fr{fr:02d}.vtk"))
                polys_by_frame[fr].append(poly_fr)

        # merge slices per frame (vtkAppendPolyData twin, :969-984)
        merged = []
        for fr in range(T):
            m = append_polydata(polys_by_frame[fr])
            if write_artifacts:
                save_polydata(m, os.path.join(output_dir,
                                              f"myo_contour_fr{fr:02d}.vtk"))
            merged.append(m)

        evaluate_strain_by_length(os.path.join(output_dir, "myo_contour_fr"),
                                  T, dt, output_name_stem, polys=merged,
                                  write_vtk=write_artifacts)
        if eval_dice and dice_rows:
            df = pd.DataFrame(dice_rows)
            with span("ukbb.io.csv"):
                df.to_csv(os.path.join(output_dir, "dice_cine_warp_ffd.csv"),
                          index=None, header=None)
            return df
        return None


def cine_2d_sa_motion_and_strain_analysis(data_dir: str, output_dir: str,
                                          output_name_stem: str,
                                          cfg: RegConfig = RegConfig(),
                                          eval_dice: bool = False,
                                          register_batch=None, mesh=None,
                                          device=None,
                                          inverse_consistent: bool = True
                                          ) -> Optional[pd.DataFrame]:
    """Full SA strain driver (``cardiac_utils.py:840-987``), MIRTK-free.

    Expects ``<data_dir>/{sa,seg_sa,seg_sa_ED}.nii.gz``; writes contour
    VTKs + strain CSVs ``<output_name_stem>_{radial,circum}.csv``.
    Returns the per-frame LV/Myo warp-Dice table when ``eval_dice``.
    ``inverse_consistent=False`` registers every pair in both directions,
    as the reference does.  ``register_batch``: an optional prebuilt
    (possibly mesh-split) registration for this subject's LV crop;
    ``mesh``: split the pair population over a mesh.  Composed from
    :func:`start_sa_motion_dispatch`
    + :func:`finish_sa_motion`.
    """
    ctx = start_sa_motion_dispatch(data_dir, output_dir, cfg, eval_dice,
                                   register_batch, mesh, device=device,
                                   inverse_consistent=inverse_consistent)
    if ctx is None:
        return None
    return finish_sa_motion(ctx, output_name_stem)
