"""Contour extraction and smoothing for myocardial geometry.

Reference: ``common/cardiac_utils.py:30-74`` (``approximate_contour``) and
the cv2.findContours calls throughout (e.g. ``:419-427``).

Note the axis convention inherited from the reference: cv2 treats an
array as (row=Y, col=X) while the NIfTI voxel array is (X, Y), so
contours returned by ``extract_contour`` are (y, x) pairs exactly like
cv2's output in the reference (``cardiac_utils.py:420-423``); callers
unpack ``y, x = point``.

The port's copy of ``ukbb_cardiac_tpu/phenotype/contours.py``.
"""

from __future__ import annotations

import cv2
import numpy as np
from scipy import interpolate


def lv_slice_masks(seg_z: np.ndarray, lv: int = 1, myo: int = 2):
    """Cleaned endo/myo/epi masks for one slice — THE mask-cleanup policy
    shared by QC gates, AHA geometry and every contour extractor
    (``cardiac_utils.py:179-187``): largest CC for the LV cavity,
    small-CC removal for the (possibly apex-split) myocardium, largest CC
    of their union for the epicardium.  Returns (endo, myo, epi) uint8."""
    from benchmark.reference.port.ops.cc import get_largest_cc, remove_small_cc

    endo = get_largest_cc(seg_z == lv).astype(np.uint8)
    myo_m = remove_small_cc(seg_z == myo).astype(np.uint8)
    epi = get_largest_cc(endo | myo_m).astype(np.uint8)
    return endo, myo_m, epi


def contour_to_world(contour, z, affine) -> np.ndarray:
    """Map an ``extract_contour`` (N, 2) (y, x) point list on slice ``z``
    to world coordinates: the cv2-(y,x) → NIfTI-(x,y) swap (module
    docstring) followed by the affine.  Returns (N, 3)."""
    contour = np.asarray(contour)
    n = len(contour)
    vox = np.concatenate([contour[:, 1:2], contour[:, 0:1],
                          np.full((n, 1), z), np.ones((n, 1))], axis=1)
    return (affine @ vox.T).T[:, :3]


def extract_contour(binary: np.ndarray) -> np.ndarray:
    """First contour of a binary mask, as (N, 2) array of (y, x) pairs —
    the reference's ``cv2.findContours(...)[0][:, 0, :]`` idiom."""
    contours, _ = cv2.findContours(cv2.inRange(binary.astype(np.uint8), 1, 1),
                                   cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)
    if not contours:
        return np.zeros((0, 2), dtype=np.int32)
    return contours[0][:, 0, :]


def approximate_contour(contour: np.ndarray, factor: int = 4,
                        smooth: float = 0.05, periodic: bool = False) -> np.ndarray:
    """Upsample + spline-smooth a contour (``cardiac_utils.py:30-74``).

    Pads the parameter domain by half a period (wrapping if periodic,
    clamping otherwise) before fitting ``UnivariateSpline`` so end points
    are not underestimated.
    """
    N = len(contour)
    dt = 1.0 / N
    t = np.arange(N) * dt
    x = contour[:, 0]
    y = contour[:, 1]

    r = int(0.5 * N)
    t_pad = np.concatenate((np.arange(-r, 0) * dt, t, 1 + np.arange(0, r) * dt))
    if periodic:
        x_pad = np.concatenate((x[-r:], x, x[:r]))
        y_pad = np.concatenate((y[-r:], y, y[:r]))
    else:
        x_pad = np.concatenate((np.repeat(x[0], r), x, np.repeat(x[-1], r)))
        y_pad = np.concatenate((np.repeat(y[0], r), y, np.repeat(y[-1], r)))

    fx = interpolate.UnivariateSpline(t_pad, x_pad, s=smooth * len(t_pad))
    fy = interpolate.UnivariateSpline(t_pad, y_pad, s=smooth * len(t_pad))

    N2 = N * factor
    t2 = np.arange(N2) * (1.0 / N2)
    return np.stack((fx(t2), fy(t2)), axis=1)
