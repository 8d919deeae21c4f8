"""Intensity rescaling and z-score normalisation: host (numpy) and device
(torch) versions.

Reference semantics: ``common/image_utils.py:60-77``.  The device versions
match ``ukbb_cardiac_tpu/ops/intensity.py::rescale_intensity_jax`` and
``normalise_intensity_jax``: exact order statistics with numpy's 'linear'
interpolation, ≤16-bit integer input taken in its own type, and NaN
propagating to every percentile.  ``torch.quantile`` is not used: it refuses inputs above
2^24 elements, and one 192x208x10x50 cine has 19,968,000.
"""

from __future__ import annotations

import numpy as np
import torch


def rescale_intensity(image, thres=(1.0, 99.0)):
    """Clip to [p_lo, p_hi] percentiles and rescale to [0, 1] (host/numpy)."""
    image = np.asarray(image)
    val_l, val_h = np.percentile(image, thres)
    out = np.clip(image, val_l, val_h)
    return (out.astype(np.float32) - val_l) / (val_h - val_l)


_SMALL_INTS = (torch.int8, torch.uint8, torch.int16)


def percentiles(x: torch.Tensor, qs):
    """Exact percentiles of all of ``x`` (one sort of the flat tensor),
    one 0-dim float32 tensor per entry of ``qs``, on ``x``'s device.

    ≤16-bit integers sort in their own type; other inputs sort as float32
    (as the JAX version converts them).  Any NaN makes every percentile
    NaN, like ``np.percentile``."""
    flat = x.reshape(-1)
    if flat.dtype not in _SMALL_INTS:
        flat = flat.float()
    N = flat.numel()
    targets = []
    for q in qs:
        pos = float(q) / 100.0 * (N - 1)
        k = int(np.floor(pos))
        targets.append((k, min(k + 1, N - 1), np.float32(pos - k)))
    ranks = sorted({k for t in targets for k in t[:2]})
    # index with Python ints: no host-to-device copy, so no wait on the
    # stream while the sort runs
    ordered = torch.sort(flat).values
    vals = torch.stack([ordered[k] for k in ranks]).float()
    if flat.is_floating_point():
        vals = torch.where(torch.isnan(flat).any(),
                           torch.full_like(vals, float("nan")), vals)
    idx = {r: i for i, r in enumerate(ranks)}
    out = []
    for k0, k1, f in targets:
        v0, v1 = vals[idx[k0]], vals[idx[k1]]
        out.append(v0 + (v1 - v0) * float(f))  # f is a float32 value
    return out


def rescale_intensity_torch(image: torch.Tensor, thres=(1.0, 99.0)):
    """Device version of :func:`rescale_intensity`: float32 in [0, 1]."""
    val_l, val_h = percentiles(image, (thres[0], thres[1]))
    out = torch.clamp(image.float(), val_l, val_h)
    return (out - val_l) / (val_h - val_l)


def normalise_intensity(image, thres_roi=10.0):
    """Z-score normalise over the ROI of voxels >= the ``thres_roi``-th
    percentile (host/numpy)."""
    image = np.asarray(image)
    val_l = np.percentile(image, thres_roi)
    roi = image >= val_l
    mu, sigma = np.mean(image[roi]), np.std(image[roi])
    eps = 1e-6
    return (image - mu) / (sigma + eps)


def normalise_intensity_torch(image: torch.Tensor, thres_roi=10.0):
    """Device version of :func:`normalise_intensity`: float32.  The ROI's
    mean and standard deviation are masked sums over ``n = max(|ROI|, 1)``
    voxels; the percentile is taken on the input's own type."""
    (val_l,) = percentiles(image, (thres_roi,))
    image = image.float()
    roi = (image >= val_l).float()
    n = torch.clamp(roi.sum(), min=1.0)
    mu = (image * roi).sum() / n
    sigma = torch.sqrt((roi * (image - mu) ** 2).sum() / n)
    eps = 1e-6
    return (image - mu) / (sigma + eps)
