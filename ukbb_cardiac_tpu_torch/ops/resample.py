"""Image resampling at float coordinates: nearest-neighbour and bilinear.

Counterpart of ``ukbb_cardiac_tpu/ops/resample.py`` on its CPU path,
which is ``jax.scipy.ndimage.map_coordinates(mode="constant", cval=0)``.
Its semantics, kept here exactly:

- order 1: per axis ``lo = floor(c)``, ``w_hi = c - lo``,
  ``w_lo = 1 - w_hi``; the four corners (lo,lo), (lo,hi), (hi,lo),
  (hi,hi) each contribute ``(w_x * w_y) * v``, summed in that order;
- order 0: the index is ``c`` rounded half AWAY from zero (``lax.round``'s
  default), not half to even as ``torch.round`` would: the two differ at
  exact .5 ties, which the augmenter's rotations by multiples of 90
  degrees and the half-pixel centres of even-sized images produce;
- each corner (or the nearest index) reads 0 when IT falls outside the
  image: a coordinate just outside the image still takes its in-range
  corner's share.

Neither ``scipy.ndimage.map_coordinates`` nor ``F.grid_sample`` gives
these semantics without such a mapping.
"""

from __future__ import annotations

import math

import torch


def round_half_away(c: torch.Tensor) -> torch.Tensor:
    """Round to the nearest integer, ties away from zero (exact: ``c -
    trunc(c)`` has no rounding error)."""
    t = torch.trunc(c)
    return t + torch.where((c - t).abs() >= 0.5, torch.sign(c),
                           torch.zeros_like(c))


def sample_2d(image: torch.Tensor, coords_x: torch.Tensor,
              coords_y: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Sample float ``image[..., x, y]`` at float coordinates, zero
    outside; ``order`` 0 (nearest) or 1 (bilinear).  ``image`` is
    (…, X, Y); the coordinates share its leading axes and may have any
    trailing shape, which is the output's."""
    X, Y = image.shape[-2:]
    lead = image.shape[:-2]
    trail = coords_x.dim() - len(lead)
    boff = (torch.arange(math.prod(lead), device=image.device)
            * (X * Y)).reshape(tuple(lead) + (1,) * trail)
    flat = image.reshape(-1)

    def nodes(c):
        if order == 0:
            return [(round_half_away(c).long(), None)]
        lower = torch.floor(c)
        w_hi = c - lower
        idx = lower.long()
        return [(idx, 1 - w_hi), (idx + 1, w_hi)]

    if order not in (0, 1):
        raise ValueError(f"order must be 0 or 1, got {order}")
    out = None
    for ix, wx in nodes(coords_x):
        for iy, wy in nodes(coords_y):
            valid = (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y)
            v = flat[boff + ix.clamp(0, X - 1) * Y + iy.clamp(0, Y - 1)]
            v = torch.where(valid, v, torch.zeros_like(v))
            term = v if wx is None else (wx * wy) * v
            out = term if out is None else out + term
    return out


def _grid(X: int, Y: int, device):
    xs = torch.arange(X, dtype=torch.float32, device=device)
    ys = torch.arange(Y, dtype=torch.float32, device=device)
    return torch.meshgrid(xs, ys, indexing="ij")


def affine_transform_2d(image: torch.Tensor, matrix, offset,
                        order: int = 1) -> torch.Tensor:
    """Pull-back affine warp: out[i] = image[matrix @ i + offset], as
    ``scipy.ndimage.affine_transform(image, matrix, offset, order)`` in
    the reference augmenter (``image_utils.py:102-107``).

    ``image`` is (…, X, Y); ``matrix`` (…, 2, 2) and ``offset`` (…, 2)
    float32 tensors share its leading axes (one transform per image).
    The coordinates are ``m00 * gx + m01 * gy + o0`` in float32, in the
    JAX function's order."""
    X, Y = image.shape[-2:]
    gx, gy = _grid(X, Y, image.device)
    m = matrix[..., None, None]
    o = offset[..., None, None]
    sx = m[..., 0, 0, :, :] * gx + m[..., 0, 1, :, :] * gy + o[..., 0, :, :]
    sy = m[..., 1, 0, :, :] * gx + m[..., 1, 1, :, :] * gy + o[..., 1, :, :]
    return sample_2d(image, sx, sy, order)


def warp_image_2d(image: torch.Tensor, disp: torch.Tensor,
                  order: int = 1) -> torch.Tensor:
    """Warp by a dense displacement field: out[i] = image[i + disp[i]].
    ``image`` (X, Y); ``disp`` (2, X, Y) in voxel units."""
    X, Y = image.shape
    gx, gy = _grid(X, Y, image.device)
    return sample_2d(image, gx + disp[0], gy + disp[1], order)
