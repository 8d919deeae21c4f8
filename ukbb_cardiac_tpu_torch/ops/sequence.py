"""File-level NIfTI plumbing utilities.

Reference semantics: ``common/image_utils.py:252-339`` (``split_sequence``,
``make_sequence``, ``split_volume``, ``image_apply_mask``, ``padding``,
``auto_crop_image``).  These operate on small files between pipeline stages;
they stay host-side, using the port's pure-numpy NIfTI I/O.

The port's copy of ``ukbb_cardiac_tpu/ops/sequence.py`` (host code): the
NIfTIs it writes are byte-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.ops.crop import foreground_bbox


def split_sequence(image_name, output_name):
    """Split a 4D sequence into per-frame 3D volumes ``<output_name><t:02d>.nii.gz``."""
    nim = nifti.load(image_name)
    T = nim.header["dim"][4]
    image = np.asanyarray(nim.dataobj)
    for t in range(T):
        nifti.save(nifti.Nifti1Image(image[:, :, :, t], nim.affine), f"{output_name}{t:02d}.nii.gz")


def make_sequence(image_names, dt, output_name):
    """Stack per-frame volumes into a 4D sequence with temporal spacing dt."""
    nim = nifti.load(image_names[0])
    X, Y, Z = (int(v) for v in nim.header["dim"][1:4])
    T = len(image_names)
    image = np.zeros((X, Y, Z, T))
    for t in range(T):
        image[:, :, :, t] = np.asanyarray(nifti.load(image_names[t]).dataobj)
    out = nifti.Nifti1Image(image, nim.affine)
    out.header["pixdim"][4] = dt
    nifti.save(out, output_name)


def split_volume(image_name, output_name):
    """Split a 3D volume into per-slice files with z-shifted affines
    (``image_utils.py:281-294``)."""
    nim = nifti.load(image_name)
    Z = nim.header["dim"][3]
    image = np.asanyarray(nim.dataobj)
    for z in range(Z):
        image_slice = np.expand_dims(image[:, :, z], axis=2)
        affine2 = np.copy(nim.affine)
        affine2[:3, 3] += z * affine2[:3, 2]
        nifti.save(nifti.Nifti1Image(image_slice, affine2), f"{output_name}{z:02d}.nii.gz")


def image_apply_mask(input_name, output_name, mask_image, pad_value=-1):
    """Set voxels where mask == 0 to pad_value (``image_utils.py:297-303``)."""
    nim = nifti.load(input_name)
    image = np.array(nim.dataobj)
    image[np.asarray(mask_image) == 0] = pad_value
    nifti.save(nifti.Nifti1Image(image, nim.affine), output_name)


def padding(input_A_name, input_B_name, output_name, value_in_B, value_output):
    """Relabel: where B == value_in_B, set A := value_output (``image_utils.py:306-312``)."""
    nim = nifti.load(input_A_name)
    image_A = np.array(nim.dataobj)
    image_B = np.asanyarray(nifti.load(input_B_name).dataobj)
    image_A[image_B == value_in_B] = value_output
    nifti.save(nifti.Nifti1Image(image_A, nim.affine), output_name)


def resample_to_target(source_name, target_name, output_name, interp="linear"):
    """Resample a source image onto a target image's grid (identity world
    transform) — the ``mirtk transform-image src out -target tgt`` twin
    (``cardiac_utils.py:850-853``).  interp: 'linear' or 'nn'.

    Maps every target voxel through the target affine to world space and
    back through the source affine; works per 3D volume (loops T for 4D).
    """
    from scipy.ndimage import map_coordinates

    src = nifti.load(source_name)
    tgt = nifti.load(target_name)
    src_data = np.asanyarray(src.dataobj)
    tgt_dim = tgt.header["dim"]
    X, Y, Z = (int(v) for v in tgt_dim[1:4])

    # target voxel -> world -> source voxel
    M = np.linalg.inv(src.affine) @ tgt.affine
    gx, gy, gz = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                             indexing="ij")
    coords = np.stack([gx, gy, gz, np.ones_like(gx)], axis=0).reshape(4, -1)
    sv = (M @ coords)[:3]
    order = 0 if interp == "nn" else 1

    if src_data.ndim == 3:
        out = map_coordinates(src_data.astype(np.float64), sv, order=order,
                              mode="constant").reshape(X, Y, Z)
    else:
        T = src_data.shape[3]
        out = np.zeros((X, Y, Z, T))
        for t in range(T):
            out[..., t] = map_coordinates(
                src_data[..., t].astype(np.float64), sv, order=order,
                mode="constant").reshape(X, Y, Z)

    out_img = nifti.Nifti1Image(out, tgt.affine)
    # spatial spacing from the TARGET grid; temporal attributes from the
    # SOURCE — MIRTK's transform-image keeps the source's time axis when
    # resampling a 4D image onto a 3D -target lattice, which is how the
    # reference's strain driver still reads the true dt from sa_crop
    # (``cardiac_utils.py:850-871``)
    out_img.header["pixdim"][1:4] = tgt.header["pixdim"][1:4]
    if src_data.ndim == 4:
        out_img.header["pixdim"][4] = src.header["pixdim"][4]
    else:
        out_img.header["pixdim"][4] = tgt.header["pixdim"][4]
    nifti.save(out_img, output_name)


def auto_crop_image(input_name, output_name, reserve, verbose=False):
    """Crop to the foreground bounding box + margin, updating the affine
    (``image_utils.py:315-339``)."""
    nim = nifti.load(input_name)
    image = np.asanyarray(nim.dataobj)
    x1, x2, y1, y2, z1, z2 = foreground_bbox(image, reserve)
    if verbose:
        print("Bounding box")
        print(f"  bottom-left corner = ({x1},{y1},{z1})")
        print(f"  top-right corner = ({x2},{y2},{z2})")
    image = image[x1:x2, y1:y2, z1:z2]
    affine = np.copy(nim.affine)
    affine[:3, 3] = np.dot(affine, np.array([x1, y1, z1, 1]))[:3]
    nifti.save(nifti.Nifti1Image(image, affine), output_name)
    return (x1, x2, y1, y2, z1, z2)
