"""Bilinear image resampling at float coordinates.

Counterpart of ``ukbb_cardiac_tpu/ops/resample.py::sample_2d`` at order 1,
which is ``jax.scipy.ndimage.map_coordinates(order=1, mode="constant")``.
Its semantics, kept here exactly:

- per axis ``lo = floor(c)``, ``w_hi = c - lo``, ``w_lo = 1 - w_hi``; the
  four corners (lo,lo), (lo,hi), (hi,lo), (hi,hi) each contribute
  ``(w_x * w_y) * v``, summed in that order;
- each corner reads 0 when IT falls outside the image (a per-corner
  test): a coordinate just outside the image still takes its in-range
  corner's share.

Neither ``scipy.ndimage.map_coordinates`` nor ``F.grid_sample`` gives
these semantics without such a mapping.
"""

from __future__ import annotations

import math

import torch


def sample_2d(image: torch.Tensor, coords_x: torch.Tensor,
              coords_y: torch.Tensor) -> torch.Tensor:
    """Sample float ``image[..., x, y]`` bilinearly at float coordinates,
    zero outside.  ``image`` is (…, X, Y); the coordinates share its
    leading axes and may have any trailing shape, which is the output's."""
    X, Y = image.shape[-2:]
    lead = image.shape[:-2]
    trail = coords_x.dim() - len(lead)
    boff = (torch.arange(math.prod(lead), device=image.device)
            * (X * Y)).reshape(tuple(lead) + (1,) * trail)
    flat = image.reshape(-1)

    def nodes(c):
        lower = torch.floor(c)
        w_hi = c - lower
        idx = lower.long()
        return [(idx, 1 - w_hi), (idx + 1, w_hi)]

    out = None
    for ix, wx in nodes(coords_x):
        for iy, wy in nodes(coords_y):
            valid = (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y)
            v = flat[boff + ix.clamp(0, X - 1) * Y + iy.clamp(0, Y - 1)]
            term = (wx * wy) * torch.where(valid, v, torch.zeros_like(v))
            out = term if out is None else out + term
    return out
