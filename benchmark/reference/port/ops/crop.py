"""Centred crop (``common/image_utils.py:35-57``), deploy padding
arithmetic (``common/deploy_network.py:97-100``, the aortic deploy's
fixed grid) and the foreground bounding box of ``auto_crop_image``."""

from __future__ import annotations

import math

import numpy as np


def pad_to_multiple(X: int, Y: int, multiple: int = 16):
    """Centred padding amounts so (X, Y) become multiples of `multiple`.

    Returns ``(x_pre, x_post, y_pre, y_post)`` matching
    ``deploy_network.py:97-100``.
    """
    X2 = int(math.ceil(X / float(multiple))) * multiple
    Y2 = int(math.ceil(Y / float(multiple))) * multiple
    x_pre, y_pre = int((X2 - X) / 2), int((Y2 - Y) / 2)
    return x_pre, (X2 - X) - x_pre, y_pre, (Y2 - Y) - y_pre


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
