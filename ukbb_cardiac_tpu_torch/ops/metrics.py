"""Segmentation metrics.

Counterpart of ``ukbb_cardiac_tpu/ops/metrics.py``.  Reference semantics:
``common/image_utils.py:23-32`` (TF metrics), ``:171-175``
(``np_categorical_dice``), ``:178-224`` (``distance_metric``).  The
device metrics take tensors; the contour distance is host numpy + cv2
with a vectorised distance matrix.
"""

from __future__ import annotations

import numpy as np
import torch


def categorical_accuracy(pred, truth):
    """Mean voxel accuracy (``image_utils.py:23-25``)."""
    return torch.mean((pred == truth).float())


def categorical_dice(pred, truth, k):
    """Dice overlap for label k (``image_utils.py:28-32``)."""
    A = (pred == k).float()
    B = (truth == k).float()
    return 2 * torch.sum(A * B) / (torch.sum(A) + torch.sum(B))


def np_categorical_dice(pred, truth, k):
    """Host Dice for label k (``image_utils.py:171-175``)."""
    A = (np.asarray(pred) == k).astype(np.float32)
    B = (np.asarray(truth) == k).astype(np.float32)
    return 2 * np.sum(A * B) / (np.sum(A) + np.sum(B))


def _contour_points(binary_slice):
    # RETR_EXTERNAL: outer contours only, as the reference
    # (image_utils.py:195-197)
    import cv2

    res = cv2.findContours(
        cv2.inRange(binary_slice.astype(np.uint8), 1, 1),
        cv2.RETR_EXTERNAL,
        cv2.CHAIN_APPROX_NONE,
    )
    contours = res[0] if len(res) == 2 else res[1]
    if not contours:
        return None
    return np.vstack([c.reshape(-1, 2) for c in contours]).astype(np.float64)


def distance_metric(seg_A, seg_B, dx):
    """Mean contour distance and Hausdorff distance between two
    segmentations, per 2D slice (z axis last), averaged over the slices
    where both have a contour (``image_utils.py:178-224``)."""
    seg_A, seg_B = np.asarray(seg_A), np.asarray(seg_B)
    table_md, table_hd = [], []
    for z in range(seg_A.shape[2]):
        slice_A = seg_A[:, :, z].astype(np.uint8)
        slice_B = seg_B[:, :, z].astype(np.uint8)
        if np.sum(slice_A) == 0 or np.sum(slice_B) == 0:
            continue
        pts_A = _contour_points(slice_A)
        pts_B = _contour_points(slice_B)
        if pts_A is None or pts_B is None:
            continue
        M = np.linalg.norm(pts_A[:, None, :] - pts_B[None, :, :], axis=-1)
        md = 0.5 * (np.mean(np.min(M, axis=0))
                    + np.mean(np.min(M, axis=1))) * dx
        hd = max(np.max(np.min(M, axis=0)), np.max(np.min(M, axis=1))) * dx
        table_md.append(md)
        table_hd.append(hd)
    mean_md = np.mean(table_md) if table_md else None
    mean_hd = np.mean(table_hd) if table_hd else None
    return mean_md, mean_hd
