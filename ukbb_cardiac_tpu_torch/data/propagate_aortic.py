"""Aortic annotation propagation: sparse ED/ES labels → all frames.

Counterpart of ``ukbb_cardiac_tpu/data/propagate_aortic.py`` (twin of
``data/propagate_aortic_annotation.py``; MIRTK's NMI FFD chain of
``par/ffd_aortic_motion.cfg`` — 1 level, NMI, bending energy 1e-4 —
replaced by the port's registration).  Each unannotated frame takes its
label from the closest annotated frame, stepping frame by frame with
5-frame hops (``:132-158``); the result is ``label_ao_prop.nii.gz``, the
dense supervision of ``train_network_ao.py:233``.

The host parts (frame matching, the propagation plan, the crop and
resample, the label chaining through ``scipy.ndimage.map_coordinates``
at orders 0 and 1) are copies of the JAX package's.  On the device: all
(source, target) pairs registered in ONE ``make_register_batch`` call
(the B-spline kernels in every Adam step), then densified by
``total_field``, each a CUDA graph captured once per shape
(``reg/programs.py``).  Runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List

import numpy as np
import torch
from scipy.ndimage import map_coordinates

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.ops.sequence import (auto_crop_image,
                                                 resample_to_target)
from ukbb_cardiac_tpu_torch.reg import programs
from ukbb_cardiac_tpu_torch.reg.register import (RegConfig,
                                                 make_register_batch,
                                                 total_field)


def infer_time_frame(image_name: str, image_fr_name: str) -> int:
    """Which frame matches the annotated still
    (``propagate_aortic_annotation.py:25-37``)."""
    nim = nifti.load(image_name)
    T = int(nim.header["dim"][4])
    image = np.asanyarray(nim.dataobj)
    image_fr = np.asanyarray(nifti.load(image_fr_name).dataobj)
    if image_fr.ndim == 4:
        image_fr = image_fr[..., 0]
    diff = np.zeros(T)
    for t in range(T):
        diff[t] = np.sum(np.abs(image[:, :, :, t] - image_fr))
    return int(np.argmin(diff))


def wrap_frame_index(t_index, T):
    """Circular frame indexing (``:40-51``)."""
    return [(t + T) % T for t in t_index]


def build_propagation_plan(T: int, t_anno: List[int]
                           ) -> Dict[int, Dict[str, np.ndarray]]:
    """Assign each unannotated frame to its closest annotated frame and a
    direction, sorted closest-first (``:96-130``)."""
    prop_idx: Dict[int, Dict[str, list]] = {
        t: {"forward": [], "backward": []} for t in t_anno}
    for t in range(T):
        if t in t_anno:
            continue
        dist = np.abs(t - np.asarray(t_anno))
        dist = [x if (x <= T / 2) else (T - x) for x in dist]
        source_t = t_anno[int(np.argmin(dist))]
        d = t - source_t
        if d > T / 2:
            prop_idx[source_t]["backward"].append(t)
        elif d > 0:
            prop_idx[source_t]["forward"].append(t)
        elif d > -T / 2:
            prop_idx[source_t]["backward"].append(t)
        else:
            prop_idx[source_t]["forward"].append(t)
    for t in t_anno:
        for direction in ("forward", "backward"):
            arr = np.asarray(prop_idx[t][direction], dtype=int)
            dist = np.abs(arr - t)
            dist = np.asarray([x if (x <= T / 2) else (T - x) for x in dist])
            prop_idx[t][direction] = arr[np.argsort(dist)]
    return prop_idx


def propagation_pairs(plan, t_anno: List[int], T: int):
    """(source_t, target_t) registration pairs in label-chaining order:
    a 5-frame hop where the distance to the annotated frame is a multiple
    of 5, else one frame (``:132-158``)."""
    pairs = []
    for t in t_anno:
        for direction in ("forward", "backward"):
            for target_t in plan[t][direction]:
                if np.abs(target_t - t) % 5 == 0:
                    source_t = (target_t - 5 if direction == "forward"
                                else target_t + 5)
                else:
                    source_t = (target_t - 1 if direction == "forward"
                                else target_t + 1)
                source_t = wrap_frame_index([source_t], T)[0]
                pairs.append((source_t, int(target_t)))
    return pairs


def register_pairs(crop_img: np.ndarray, pairs, cfg: RegConfig,
                   device=None) -> np.ndarray:
    """Register every (source, target) frame pair of the (X, Y, 1, T)
    crop in one batch on ``device`` and densify: (P, X, Y, 2) float32
    pull-back displacements (target voxel -> source voxel)."""
    dev = resolve_device(device)
    X, Y = crop_img.shape[:2]
    targets = np.stack([crop_img[:, :, 0, tt] for _, tt in pairs])
    sources = np.stack([crop_img[:, :, 0, st] for st, _ in pairs])
    register_batch = make_register_batch((X, Y), cfg, device=dev)
    controls = register_batch(torch.from_numpy(targets).to(dev),
                              torch.from_numpy(sources).to(dev))
    with torch.no_grad():
        return _dense_program(controls, (X, Y), cfg).cpu().numpy()


def _dense_program(controls, image_shape, cfg: RegConfig) -> torch.Tensor:
    """:func:`total_field` of a batch of control stacks, one program per
    (device, pairs, X, Y, cfg) on the card (``reg/programs.py``; the JAX
    ``_dense_program``)."""
    image_shape = tuple(image_shape)
    return programs.run(
        ("dense-fields", image_shape, cfg),
        lambda *cs: (total_field(cs, image_shape, cfg),), *controls)[0]


def propagate_subject(data_dir: str, cfg: RegConfig = None,
                      keep_motion_dir: bool = False, verbose: bool = False,
                      device=None) -> str:
    """Propagate one subject's ED/ES aortic labels to every frame.

    Expects ``<data_dir>/{ao,ao_ED,ao_ES,label_ao,label_ao_ED,
    label_ao_ES}.nii.gz``; writes ``label_ao_prop.nii.gz``.  The
    registrations run on ``device`` (default the card).
    """
    cfg = cfg or RegConfig.aortic_motion()
    resolve_device(device)  # refuse early, before any file is written
    motion_dir = os.path.join(data_dir, "motion")
    os.makedirs(motion_dir, exist_ok=True)

    image_name = os.path.join(data_dir, "ao.nii.gz")
    nim = nifti.load(image_name)
    T = int(nim.header["dim"][4])
    dt = float(nim.header["pixdim"][4])

    labels_prop: Dict[int, np.ndarray] = {}
    t_anno = []
    for fr in ("ED", "ES"):
        image_fr_name = os.path.join(data_dir, f"ao_{fr}.nii.gz")
        if not os.path.exists(image_fr_name):
            continue
        k = infer_time_frame(image_name, image_fr_name)
        t_anno.append(k)
        lab = np.asanyarray(
            nifti.load(os.path.join(data_dir, f"label_ao_{fr}.nii.gz")).dataobj)
        labels_prop[k] = lab.astype(np.int16)
    if not t_anno:
        raise FileNotFoundError(f"{data_dir}: no annotated frames")

    # registration ROI: crop around the (4D) annotation bbox + 10
    auto_crop_image(os.path.join(data_dir, "label_ao.nii.gz"),
                    os.path.join(motion_dir, "label_ao_crop.nii.gz"), 10)
    resample_to_target(image_name,
                       os.path.join(motion_dir, "label_ao_crop.nii.gz"),
                       os.path.join(motion_dir, "ao_crop.nii.gz"))
    crop = nifti.load(os.path.join(motion_dir, "ao_crop.nii.gz"))
    crop_img = np.asanyarray(crop.dataobj).astype(np.float32)
    inv_crop = np.linalg.inv(crop.affine)
    full = np.asanyarray(nim.dataobj)
    full_affine = nim.affine

    plan = build_propagation_plan(T, t_anno)

    # full-grid voxel coords mapped into crop-voxel space (for warping the
    # full-resolution label through the crop-space displacement)
    FX, FY = full.shape[:2]
    gx, gy = np.meshgrid(np.arange(FX), np.arange(FY), indexing="ij")
    vox_full = np.stack([gx.ravel(), gy.ravel(), np.zeros(FX * FY),
                         np.ones(FX * FY)])
    crop_coords = (inv_crop @ full_affine @ vox_full)[:2]

    # the registrations are independent (image frame -> image frame); only
    # the LABEL chaining is sequential, on the host through the fields
    pairs = propagation_pairs(plan, t_anno, T)
    if pairs:
        disps = register_pairs(crop_img, pairs, cfg, device)

    for k, (source_t, target_t) in enumerate(pairs):
        if verbose:
            print(f"{source_t} -> {target_t}")
        disp = disps[k]
        # pull-back on the FULL grid: the crop grid is a pure voxel
        # translation of the full grid (same axes and spacing), so a
        # crop-voxel displacement is also a full-voxel displacement.
        # label_target(v) = label_source(v + d(v)), nearest neighbour
        # (mirtk transform-image -interp NN).
        dx = map_coordinates(disp[..., 0], crop_coords, order=1,
                             mode="constant")
        dy = map_coordinates(disp[..., 1], crop_coords, order=1,
                             mode="constant")
        src_lab = labels_prop[source_t][:, :, 0].astype(float)
        warped = map_coordinates(
            src_lab, [gx.ravel() + dx, gy.ravel() + dy],
            order=0, mode="constant").reshape(FX, FY)
        labels_prop[target_t] = warped.astype(np.int16)[:, :, None]

    # combine into a 4D sequence
    prop = np.zeros(full.shape, dtype=np.int16)
    for t in range(T):
        prop[:, :, :, t] = labels_prop[t]
    out = nifti.Nifti1Image(prop.astype(np.float64), full_affine)
    out.header["pixdim"][4] = dt
    out_name = os.path.join(data_dir, "label_ao_prop.nii.gz")
    nifti.save(out, out_name)
    if not keep_motion_dir:
        shutil.rmtree(motion_dir, ignore_errors=True)
    return out_name
