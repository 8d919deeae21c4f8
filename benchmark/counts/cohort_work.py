"""The work of one cohort pass, from the shapes the window ran: the
segmentation networks' forward FLOPs, the head's calls and the
registration's B-spline calls."""

from __future__ import annotations

import numpy as np

from benchmark.counts.bspline_bounds import bspline_bounds, registration_calls
from benchmark.counts.fcn_flops import fcn_forward_flops
from benchmark.counts.head_bound import fcn_head_levels, head_bound
from benchmark.counts.unet_lstm_flops import unet_lstm_forward_flops


def padded(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def forward_flops(config: dict, shape) -> float:
    """FLOPs of the segmentation network over a cine (X, Y, Z, T) at the
    size the network runs it: SA slices padded to multiples of 16, aortic
    frames on the 256 x 256 grid."""
    X, Y, Z, T = shape
    if config["model"] == "fcn":
        return Z * T * fcn_forward_flops(config["network"], padded(X, 16),
                                         padded(Y, 16))
    if config["model"] == "unet_lstm":
        s = config["pad_to"]
        return Z * unet_lstm_forward_flops(config["network"], T, s, s)
    raise ValueError(f"unknown model {config['model']!r}")


def head_seconds(config: dict, shape) -> float:
    """Least time of the FCN head over a cine's Z * T slices."""
    X, Y, Z, T = shape
    net = config["network"]
    return head_bound(Z * T, fcn_head_levels(net, padded(X, 16),
                                             padded(Y, 16)),
                      net["n_class"], net["same_dim"], net["fc"])[0]


def strain_image(ed_labels: np.ndarray, margin: int = 20,
                 bucket: int = 32):
    """The SA strain stage's registration image for ED labels (X, Y, Z):
    the LV and myocardium's bounding box grown by ``margin`` voxels,
    clipped to the image, rounded up to multiples of ``bucket``."""
    idx = np.nonzero((ed_labels > 0) & (ed_labels != 3))
    X, Y = ed_labels.shape[:2]
    w = min(int(idx[0].max()) + margin + 1, X) - max(int(idx[0].min())
                                                    - margin, 0)
    h = min(int(idx[1].max()) + margin + 1, Y) - max(int(idx[1].min())
                                                    - margin, 0)
    return padded(w, bucket), padded(h, bucket)


def bspline_seconds(config: dict, T: int, image, slices: int = 3) -> float:
    """Least time of every B-spline synthesis and adjoint of one
    subject's SA strain: ``slices`` x T pairs registered together."""
    total = 0.0
    for kind, B, lat, shape, s in registration_calls(
            slices * T, image, config["registration"]):
        total += bspline_bounds(B, lat, shape, s)[kind][0]
    return total
