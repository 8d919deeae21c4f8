"""Connected-component utilities.

The port's copy of ``ukbb_cardiac_tpu/ops/cc.py``.  2D masks (the QC
gates' per-frame passes, O(labels x frames) per subject) go through the
port's native union-find library (``native/hostops.cc``), whose build
raises if it fails; 3D masks go to scipy.  The scipy versions
(``*_scipy``) stay here as the plain versions the tests hold the native
path to: the same components, the same first-in-raster-order choice
among equal largest ones.  Reference semantics:
``common/image_utils.py:227-249`` (``get_largest_cc``,
``remove_small_cc``), the QC fragmentation criterion
(``cardiac_utils.py:1629-1643``) and the aortic trainer's trusted-region
mask (``train_network_ao.py:81-95``).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def get_largest_cc(binary):
    """Largest foreground connected component as a boolean mask
    (4-connectivity, matching scipy.ndimage.label defaults)."""
    binary = np.asarray(binary)
    return get_largest_cc_scipy(binary)


def get_largest_cc_scipy(binary):
    """:func:`get_largest_cc` through ``scipy.ndimage.label``."""
    binary = np.asarray(binary)
    cc, n_cc = ndimage.label(binary)
    if n_cc == 0:
        return np.zeros_like(binary, dtype=bool)
    areas = np.bincount(cc.ravel())[1:]  # skip background
    return cc == (int(np.argmax(areas)) + 1)


def label_cc(binary, connectivity=1):
    """Connected-component labelling with selectable connectivity.

    connectivity=1 → faces only (scipy default, used by get_largest_cc);
    connectivity=ndim → full neighbourhood (the ``skimage.measure.label(
    ..., connectivity=2)`` the reference QC gates use,
    ``cardiac_utils.py:1633,1770``). Returns (labels, n)."""
    binary = np.asarray(binary)
    structure = ndimage.generate_binary_structure(binary.ndim, connectivity)
    return ndimage.label(binary, structure=structure)


def count_significant_cc(binary, pixel_thres=10, connectivity=2):
    """Number of connected components larger than ``pixel_thres`` pixels
    (the reference's fragmentation criterion, ``cardiac_utils.py:1629-1643``)."""
    binary = np.asarray(binary)
    return count_significant_cc_scipy(binary, pixel_thres, connectivity)


def count_significant_cc_scipy(binary, pixel_thres=10, connectivity=2):
    """:func:`count_significant_cc` through ``scipy.ndimage.label``."""
    cc, n_cc = label_cc(binary, connectivity)
    if n_cc == 0:
        return 0
    areas = np.bincount(cc.ravel())[1:]
    return int(np.sum(areas > pixel_thres))


def remove_small_cc(binary, thres=10):
    """Zero out connected components smaller than `thres` pixels."""
    binary = np.asarray(binary)
    return remove_small_cc_scipy(binary, thres)


def remove_small_cc_scipy(binary, thres=10):
    """:func:`remove_small_cc` through ``scipy.ndimage.label``."""
    binary = np.asarray(binary)
    cc, n_cc = ndimage.label(binary)
    if n_cc == 0:
        return np.copy(binary)
    areas = np.bincount(cc.ravel())
    small = areas < thres
    small[0] = False
    out = np.copy(binary)
    out[small[cc]] = 0
    return out

