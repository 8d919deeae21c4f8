"""Data augmentation for the trainers: a random affine per slice (SA/LA)
or per time window (aortic).

Counterpart of ``ukbb_cardiac_tpu/ops/augment.py``.  Reference semantics:
``common/image_utils.py:80-120``: per slice a Gaussian shift, rotation,
scale and intensity factor, each draw clipped to ±3σ, then an optional
random flip along one axis.

- :func:`data_augmenter` is the host twin (numpy + scipy), a copy of the
  JAX package's: the same ``np.random.RandomState`` gives byte-identical
  outputs.
- :func:`data_augmenter_torch` is the device augmenter: the parameters are
  drawn from a ``torch.Generator`` on the images' device and applied by
  :func:`augment_with_params`, one batched warp for all slices (image
  bilinear, label nearest, as ``resample.affine_transform_2d`` on the JAX
  package's CPU path).  ``augment_with_params`` is the parity seam: a
  test hands the same drawn parameters to both packages.  The trainers'
  steps split the draw (:func:`sample_shard_params`, before a call) from
  the warp (inside the call's CUDA graph), so a graph never holds a
  seed.

The aortic (sequence-consistent) augmenters draw one transform per
window and apply it to every frame of it (``image_utils.py:123-168``):
:func:`aortic_data_augmenter` is the host copy, byte-identical under the
same ``np.random.RandomState``, and :func:`aortic_batch_augmenter_torch`
the device one, with :func:`aortic_augment_with_params` as its seam.
As in the JAX package, the device augmenter draws one flip direction per
window where the host twin keeps the reference's per-frame redraw.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import ndimage

from ukbb_cardiac_tpu_torch.ops.resample import affine_transform_2d


def _rotation_matrix(centre, angle_deg, scale):
    """cv2.getRotationMatrix2D-compatible 2x3 matrix (numpy, float64)."""
    angle = math.radians(angle_deg)
    a = scale * math.cos(angle)
    b = scale * math.sin(angle)
    cx, cy = centre
    return np.array(
        [[a, b, (1 - a) * cx - b * cy], [-b, a, b * cx + (1 - a) * cy]],
        dtype=np.float64)


def data_augmenter(image, label, shift, rotate, scale, intensity, flip,
                   rng=None):
    """Host augmenter (``image_utils.py:80-120``).

    image: (N, X, Y, C) float; label: (N, X, Y) int.  Each slice gets an
    independent random affine; Gaussian draws are clipped to ±3σ.
    """
    rng = np.random if rng is None else rng
    image = np.asarray(image)
    label = np.asarray(label)
    image2 = np.zeros(image.shape, dtype=np.float32)
    label2 = np.zeros(label.shape, dtype=np.int32)
    for i in range(image.shape[0]):
        shift_val = [np.clip(rng.normal(), -3, 3) * shift,
                     np.clip(rng.normal(), -3, 3) * shift]
        rotate_val = np.clip(rng.normal(), -3, 3) * rotate
        scale_val = 1 + np.clip(rng.normal(), -3, 3) * scale
        intensity_val = 1 + np.clip(rng.normal(), -3, 3) * intensity

        row, col = image.shape[1:3]
        M = _rotation_matrix((row / 2, col / 2), rotate_val, 1.0 / scale_val)
        M[:, 2] += shift_val
        for c in range(image.shape[3]):
            image2[i, :, :, c] = ndimage.affine_transform(
                image[i, :, :, c], M[:, :2], M[:, 2], order=1)
        label2[i, :, :] = ndimage.affine_transform(label[i, :, :], M[:, :2],
                                                   M[:, 2], order=0)
        image2[i] *= intensity_val

        if flip:
            if rng.uniform() >= 0.5:
                image2[i] = image2[i, ::-1, :, :]
                label2[i] = label2[i, ::-1, :]
            else:
                image2[i] = image2[i, :, ::-1, :]
                label2[i] = label2[i, :, ::-1]
    return image2, label2


def sample_params(generator: torch.Generator, n: int, shift, rotate, scale,
                  intensity, device=None):
    """Draw ``n`` slices' augmentation parameters: shift (n, 2), rotate,
    scale and intensity (n,) float32, each a ±3σ-clipped Gaussian, and
    flip_x (n,) bool from a uniform draw (``uniform >= 0.5`` flips the X
    axis, else the Y axis — used only when flipping is on)."""
    z = torch.randn((n, 5), generator=generator, device=device).clamp(-3, 3)
    u = torch.rand((n,), generator=generator, device=device)
    return {"shift": z[:, :2] * shift, "rotate": z[:, 2] * rotate,
            "scale": 1 + z[:, 3] * scale, "intensity": 1 + z[:, 4] * intensity,
            "flip_x": u >= 0.5}


def affine_from_params(row: int, col: int, shift, rotate, scale):
    """Per-slice (n, 2, 2) matrix and (n, 2) offset equal to
    cv2.getRotationMatrix2D about (row/2, col/2) plus the shift, in
    float32 (``augment._affine_from_params``)."""
    angle = rotate * (math.pi / 180.0)
    s = 1.0 / scale
    a = s * torch.cos(angle)
    b = s * torch.sin(angle)
    cx, cy = row / 2.0, col / 2.0
    matrix = torch.stack([torch.stack([a, b], -1),
                          torch.stack([-b, a], -1)], -2)
    offset = torch.stack([(1 - a) * cx - b * cy + shift[:, 0],
                          b * cx + (1 - a) * cy + shift[:, 1]], -1)
    return matrix, offset


def augment_with_params(image: torch.Tensor, label: torch.Tensor, params,
                        flip: bool):
    """Apply drawn parameters (:func:`sample_params`) to a batch.

    image (N, X, Y, C) float, label (N, X, Y) integer -> float32 image
    warped bilinearly and scaled by the intensity factor, int32 label
    warped nearest-neighbour; with ``flip`` each slice is then reversed
    along X (``flip_x``) or Y."""
    N, X, Y, _ = image.shape
    matrix, offset = affine_from_params(X, Y, params["shift"],
                                        params["rotate"], params["scale"])
    img = affine_transform_2d(image.float().permute(0, 3, 1, 2),
                              matrix[:, None], offset[:, None], order=1)
    img = img.permute(0, 2, 3, 1) * params["intensity"].view(N, 1, 1, 1)
    lab = affine_transform_2d(label.float(), matrix, offset,
                              order=0).to(torch.int32)
    if flip:
        fx = params["flip_x"]
        img = torch.where(fx.view(N, 1, 1, 1), img.flip(1), img.flip(2))
        lab = torch.where(fx.view(N, 1, 1), lab.flip(1), lab.flip(2))
    return img, lab


def sample_shard_params(generator: torch.Generator, n: int, shift, rotate,
                        scale, intensity, device=None, shard=None):
    """:func:`sample_params` for this rank's ``n`` rows of a batch split
    evenly over ranks: ``shard`` (rank, world) draws the parameters of
    the global batch of world x n rows and keeps rows [rank n, (rank + 1)
    n), so every split of a batch draws what one process would."""
    rank, world = shard or (0, 1)
    params = sample_params(generator, n * world, shift, rotate, scale,
                           intensity, device=device)
    if world == 1:
        return params
    return {k: v[rank * n:(rank + 1) * n] for k, v in params.items()}


def data_augmenter_torch(generator: torch.Generator, image: torch.Tensor,
                         label: torch.Tensor, shift, rotate, scale,
                         intensity, flip: bool, shard=None):
    """Device augmenter: an independent transform per slice, drawn from
    ``generator`` (on the images' device).  image (N, X, Y, C), label
    (N, X, Y) -> (float32 image, int32 label).  ``shard``: (rank, world)
    of a data-parallel step (:func:`sample_shard_params`)."""
    params = sample_shard_params(generator, image.shape[0], shift, rotate,
                                 scale, intensity, image.device, shard)
    return augment_with_params(image, label, params, flip)


def aortic_data_augmenter(image, label, shift, rotate, scale, intensity,
                          flip, rng=None):
    """Host twin of the sequence-consistent augmenter
    (``image_utils.py:123-168``): one transform shared by all N frames of
    a window.  image (N, X, Y, C), label (N, X, Y)."""
    rng = np.random if rng is None else rng
    image = np.asarray(image)
    label = np.asarray(label)
    image2 = np.zeros(image.shape, dtype=np.float32)
    label2 = np.zeros(label.shape, dtype=np.int32)
    shift_val = [np.clip(rng.normal(), -3, 3) * shift,
                 np.clip(rng.normal(), -3, 3) * shift]
    rotate_val = np.clip(rng.normal(), -3, 3) * rotate
    scale_val = 1 + np.clip(rng.normal(), -3, 3) * scale
    intensity_val = 1 + np.clip(rng.normal(), -3, 3) * intensity

    row, col = image.shape[1:3]
    M = _rotation_matrix((row / 2, col / 2), rotate_val, 1.0 / scale_val)
    M[:, 2] += shift_val
    for i in range(image.shape[0]):
        for c in range(image.shape[3]):
            image2[i, :, :, c] = ndimage.affine_transform(
                image[i, :, :, c], M[:, :2], M[:, 2], order=1)
        label2[i, :, :] = ndimage.affine_transform(label[i, :, :], M[:, :2],
                                                   M[:, 2], order=0)
        image2[i] *= intensity_val
        if flip:
            if rng.uniform() >= 0.5:
                image2[i] = image2[i, ::-1, :, :]
                label2[i] = label2[i, ::-1, :]
            else:
                image2[i] = image2[i, :, ::-1, :]
                label2[i] = label2[i, :, ::-1]
    return image2, label2


def aortic_augment_with_params(images: torch.Tensor, labels: torch.Tensor,
                               params, flip: bool):
    """Apply one drawn transform per window (:func:`sample_params` over
    the B windows) to every frame of it.  images (B, T, X, Y, C), labels
    (B, T, X, Y) -> (float32 images, int32 labels) of the same shapes."""
    B, T = images.shape[:2]
    per_frame = {k: v.repeat_interleave(T, dim=0) for k, v in params.items()}
    img, lab = augment_with_params(images.flatten(0, 1),
                                   labels.flatten(0, 1), per_frame, flip)
    return img.view(images.shape), lab.view(labels.shape)


def aortic_batch_augmenter_torch(generator: torch.Generator,
                                 images: torch.Tensor, labels: torch.Tensor,
                                 shift, rotate, scale, intensity,
                                 flip: bool, shard=None):
    """Device augmenter for a batch of windows (B, T, X, Y, C) / (B, T, X,
    Y): an independent window-consistent transform per window, drawn from
    ``generator`` (on the images' device) — the twin of drawing
    :func:`aortic_data_augmenter` once per window in the host sampler
    (``train_network_ao.py:190-196``).  ``shard``: (rank, world) of a
    data-parallel step (:func:`sample_shard_params`)."""
    params = sample_shard_params(generator, images.shape[0], shift, rotate,
                                 scale, intensity, images.device, shard)
    return aortic_augment_with_params(images, labels, params, flip)
