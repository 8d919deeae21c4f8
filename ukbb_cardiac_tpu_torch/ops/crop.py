"""Centred crop (``common/image_utils.py:35-57``), deploy padding
arithmetic (``common/deploy_network.py:97-100``, the aortic deploy's
fixed grid) and the foreground bounding box of ``auto_crop_image``."""

from __future__ import annotations

import math

import numpy as np


def crop_image(image, cx, cy, size):
    """Crop a 3D/4D image with a centred box of `size`, zero-padding
    overflow, with the reference's even-size arithmetic (r = size//2; the
    box is [c-r, c+r), so the output side is 2*r)."""
    image = np.asarray(image)
    X, Y = image.shape[:2]
    r = int(size / 2)
    x1, x2 = cx - r, cx + r
    y1, y2 = cy - r, cy + r
    x1_, x2_ = max(x1, 0), min(x2, X)
    y1_, y2_ = max(y1, 0), min(y2, Y)
    crop = image[x1_:x2_, y1_:y2_]
    pad = ([(x1_ - x1, x2 - x2_), (y1_ - y1, y2 - y2_)]
           + [(0, 0)] * (image.ndim - 2))
    if image.ndim not in (3, 4):
        raise ValueError(f"unsupported dimension, ndim = {image.ndim}")
    return np.pad(crop, pad, "constant")


def pad_to_multiple(X: int, Y: int, multiple: int = 16):
    """Centred padding amounts so (X, Y) become multiples of `multiple`.

    Returns ``(x_pre, x_post, y_pre, y_post)`` matching
    ``deploy_network.py:97-100``.
    """
    X2 = int(math.ceil(X / float(multiple))) * multiple
    Y2 = int(math.ceil(Y / float(multiple))) * multiple
    x_pre, y_pre = int((X2 - X) / 2), int((Y2 - Y) / 2)
    return x_pre, (X2 - X) - x_pre, y_pre, (Y2 - Y) - y_pre


def pad_image_to_multiple(image, multiple: int = 16):
    """Zero-pad the first two axes, centred, to a multiple of
    ``multiple``; returns (padded, (x_pre, x_post, y_pre, y_post))."""
    image = np.asarray(image)
    pads = pad_to_multiple(*image.shape[:2], multiple)
    pad = ([pads[:2], pads[2:]] + [(0, 0)] * (image.ndim - 2))
    return np.pad(image, pad, "constant"), pads


def pad_to_size(X: int, Y: int, size: int):
    """Centred padding amounts to reach a fixed (size, size) canvas, as
    the aortic deployer pads to 256 x 256 (``deploy_network_ao.py:104-108``).
    Returns ``(x_pre, x_post, y_pre, y_post)``."""
    x_pre, y_pre = int((size - X) / 2), int((size - Y) / 2)
    return x_pre, (size - X) - x_pre, y_pre, (size - Y) - y_pre


def foreground_bbox(image, reserve: int = 0):
    """Bounding box of voxels > 0, expanded by `reserve`, clipped to bounds.

    The core of ``image_utils.py:315-339`` (``auto_crop_image``) minus file
    I/O.
    """
    image = np.asarray(image)
    X, Y, Z = image.shape[:3]
    idx = np.nonzero(image > 0)
    if len(idx[0]) == 0:
        raise ValueError(
            "foreground_bbox: no voxels > 0 — cannot auto-crop an empty "
            "image/segmentation (check the upstream mask)")
    x1, x2 = idx[0].min() - reserve, idx[0].max() + reserve + 1
    y1, y2 = idx[1].min() - reserve, idx[1].max() + reserve + 1
    z1, z2 = idx[2].min() - reserve, idx[2].max() + reserve + 1
    return (
        max(int(x1), 0), min(int(x2), X),
        max(int(y1), 0), min(int(y2), Y),
        max(int(z1), 0), min(int(z2), Z),
    )
