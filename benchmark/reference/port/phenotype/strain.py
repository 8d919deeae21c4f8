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

import numpy as np
import pandas as pd
import torch

from benchmark.reference.port import resolve_device
from benchmark.reference.port.io import nifti
from benchmark.reference.port.io.vtkio import (PolyData, append_polydata,
                                             load_polydata)
from benchmark.reference.port.ops.crop import foreground_bbox
from benchmark.reference.port.phenotype.myo_contour import \
    extract_myocardial_contour
from benchmark.reference.port.reg import programs
from benchmark.reference.port.reg.register import (RegConfig, compose_chain,
                                                 invert_field_batch,
                                                 make_register_batch,
                                                 total_field)


def evaluate_strain_by_length(polys, T: int, dt: float,
                              output_name_stem: str) -> None:
    """Lagrangian strain per line cell vs ED; per-AHA-segment tables
    (``cardiac_utils.py:755-837``) of the per-frame polydata ``polys``,
    written to ``<out>_radial.csv`` / ``<out>_circum.csv``."""
    poly_ED = polys[0]
    pts = poly_ED.points
    lines_arr = np.asarray(poly_ED.lines)
    length_ED = np.linalg.norm(pts[lines_arr[:, 0]] - pts[lines_arr[:, 1]],
                               axis=1)
    seg_id = poly_ED.cell_scalars["Segment_ID"]
    dir_id = poly_ED.cell_scalars["Direction_ID"]

    table_strain = {"radial": np.zeros((17, T)), "circum": np.zeros((17, T))}
    for fr in range(T):
        poly = polys[fr]
        p = poly.points
        d = np.linalg.norm(p[lines_arr[:, 0]] - p[lines_arr[:, 1]], axis=1)
        strain = (d - length_ED) / length_ED * 100

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


def bucket_points(n: int) -> int:
    """``n`` contour points (at least 1) rounded up to the bucket."""
    return -(-max(n, 1) // _PTS_BUCKET) * _PTS_BUCKET


def track_multi_slice_fields(frames_zs: np.ndarray, cfg: RegConfig,
                             register_batch=None, device=None,
                             inverse_consistent: bool = True
                             ) -> torch.Tensor:
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
    prebuilt :func:`make_register_batch` for (X, Y).
    """
    dev = resolve_device(device)
    Z, T, X, Y = frames_zs.shape
    if register_batch is None:
        register_batch = make_register_batch((X, Y), cfg, device=dev)
    targets, sources = pair_frames(frames_zs, inverse_consistent)
    controls = register_batch(torch.from_numpy(targets).to(dev),
                              torch.from_numpy(sources).to(dev))
    controls = tuple(c.to(dev) for c in controls)
    with torch.no_grad():
        return _field_program(controls, (X, Y), Z, T, cfg,
                              inverse_consistent)


def start_sa_motion_dispatch(data_dir: str, output_dir: str,
                             cfg: RegConfig = RegConfig(),
                             register_batch=None, device=None,
                             inverse_consistent: bool = True):
    """Stage 1 of the SA strain driver: crop, ED contours, and the whole
    registration + composition on ``device``.  Returns a context for
    :func:`finish_sa_motion`, or None when no slice qualifies.
    ``inverse_consistent``: see :func:`track_multi_slice_fields`.
    ``register_batch``: a prebuilt registration for this subject's LV
    crop, which is then not padded to the bucket.
    """
    dev = resolve_device(device)
    # LV-focused crop (cardiac_utils.py:845-853): relabel RV->BG, bbox+20;
    # the crop shares the source grid, so it is an exact slice in memory
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

    # ED contours on the three representative slices (basal/mid/apical);
    # stale contour files of another subject would be trusted below
    for stale in _glob.glob(os.path.join(output_dir,
                                         "myo_contour_ED_z*.vtk")):
        os.remove(stale)
    extract_myocardial_contour(os.path.join(data_dir, "seg_sa_ED.nii.gz"),
                               os.path.join(output_dir, "myo_contour_ED_z"),
                               three_slices=True)

    Z = sa_crop.shape[2]
    T = sa_crop.shape[3]
    dt = float(sa_nim.header["pixdim"][4])
    inv_affine = np.linalg.inv(affine_crop)
    X, Y = sa_crop.shape[:2]

    selected = [z for z in range(Z) if os.path.exists(
        os.path.join(output_dir, f"myo_contour_ED_z{z:02d}.vtk"))]
    if not selected:
        return None
    frames_zs = np.stack([np.transpose(sa_crop[:, :, z, :], (2, 0, 1))
                          for z in selected])  # (Zsel, T, X, Y)
    # zero-pad to the bucket: the reference solves the padded problem (a
    # prebuilt registration has the shape its caller chose)
    Xp, Yp = (X, Y) if register_batch is not None else bucket_hw(X, Y)
    frames_zs = np.pad(frames_zs, ((0, 0), (0, 0), (0, Xp - X), (0, Yp - Y)))

    # the contour points (and labels) go up before the registration is
    # queued: a host-to-device copy waits for the stream, and this function
    # returns with the registration still running on the card
    polys_ED, voxs = [], []
    for z in selected:
        poly = load_polydata(
            os.path.join(output_dir, f"myo_contour_ED_z{z:02d}.vtk"))
        world = poly.points
        voxs.append((inv_affine @ np.concatenate(
            [world, np.ones((len(world), 1))], axis=1).T).T[:, :3])
        polys_ED.append(poly)
    pts = np.zeros((len(selected), bucket_points(max(len(v) for v in voxs)),
                    2), np.float32)
    for i, v in enumerate(voxs):
        pts[i, :len(v)] = v[:, :2]
    pts_dev = torch.from_numpy(pts).to(dev)

    # the dense fields stay on the device; only the points' moves return
    fields = track_multi_slice_fields(frames_zs, cfg, register_batch,
                                      device=dev,
                                      inverse_consistent=inverse_consistent)
    with torch.no_grad():
        disp = sample_points(fields, pts_dev)
    return {"output_dir": output_dir, "selected": selected,
            "disp_dev": disp, "polys_ED": polys_ED, "voxs": voxs,
            "T": T, "dt": dt, "affine_crop": affine_crop}


def finish_sa_motion(ctx: dict, output_name_stem: str) -> None:
    """Stage 2 of the SA strain driver: fetch the contour points' moves,
    build the per-frame contour polydata and write the strain tables
    (``cardiac_utils.py:938-987``)."""
    selected = ctx["selected"]
    T, dt = ctx["T"], ctx["dt"]
    affine_crop = ctx["affine_crop"]
    disp_zs = ctx["disp_dev"].cpu().numpy().astype(np.float32)
    polys_by_frame = [[] for _ in range(T)]

    for zi, z in enumerate(selected):
        poly_ED = ctx["polys_ED"][zi]
        vox = ctx["voxs"][zi]

        for fr in range(T):
            vox_fr = vox.copy()
            vox_fr[:, :2] += disp_zs[zi, fr, :len(vox)]
            world_fr = (affine_crop @ np.concatenate(
                [vox_fr, np.ones((len(vox_fr), 1))], axis=1).T).T[:, :3]
            polys_by_frame[fr].append(PolyData(
                points=world_fr, lines=list(poly_ED.lines),
                point_scalars=dict(poly_ED.point_scalars),
                point_vectors=dict(poly_ED.point_vectors),
                cell_scalars=dict(poly_ED.cell_scalars)))

    # merge slices per frame (vtkAppendPolyData twin, :969-984)
    merged = [append_polydata(polys_by_frame[fr]) for fr in range(T)]
    evaluate_strain_by_length(merged, T, dt, output_name_stem)
