"""Loss functions for segmentation training.

Counterpart of ``ukbb_cardiac_tpu/models/losses.py``.  Reference: softmax
cross-entropy (``train_network.py:204-206``, ``network_ao.py:151-154``),
focal loss (``network_ao.py:117-135``) and the triangular time-window-
weighted CE of the temporal models (``network_ao.py:179-204,354-381``).
Logits are channels-last, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _onehot_log_p(logits, labels, n_class: int):
    log_p = F.log_softmax(logits, dim=-1)
    # a comparison, not F.one_hot: on the CPU that reads the labels'
    # range back to the host, which a step under test must not do
    classes = torch.arange(n_class, device=labels.device)
    onehot = (labels.long()[..., None] == classes).to(log_p.dtype)
    return log_p, onehot


def softmax_cross_entropy(logits, labels, n_class: int):
    """Mean softmax CE with integer labels. logits (..., C), labels (...)."""
    log_p, onehot = _onehot_log_p(logits, labels, n_class)
    return -torch.mean(torch.sum(onehot * log_p, dim=-1))


def focal_loss(labels, logits, n_class: int, alpha: float):
    """Class-balanced loss as implemented by the reference
    (``network_ao.py:117-135``): despite its name an alpha-balanced CE
    (no (1-p)^gamma modulation); the one-hot target is scaled by alpha
    for foreground and (1-alpha) for background.  Kept verbatim for
    parity."""
    log_p, onehot = _onehot_log_p(logits, labels, n_class)
    alpha_t = torch.where(labels != 0, alpha, 1.0 - alpha)[..., None]
    return -torch.mean(torch.sum(alpha_t * onehot * log_p, dim=-1))


_WINDOW_WEIGHTS = {}


def temporal_window_weights(n_step: int, weight_R: int, weight_r: float,
                            device=None):
    """Triangular window weights w_t = (1 - d/R)^r for |d| <= R else 0,
    centred at s = (n_step-1)//2 (``network_ao.py:179-195``).  Made once
    per (window, R, r, device) and kept: an upload inside a training
    step would wait for the card, and a CUDA graph could not hold it.
    Made outside inference mode, so that a backward can save it.
    Read-only."""
    key = (n_step, weight_R, float(weight_r), str(torch.device(
        device or "cpu")))
    if key not in _WINDOW_WEIGHTS:
        s = (n_step - 1) // 2
        w = []
        for t in range(n_step):
            d = abs(t - s)
            w.append(pow(1.0 - float(d) / weight_R, weight_r)
                     if d <= weight_R else 0.0)
        with torch.inference_mode(False):
            _WINDOW_WEIGHTS[key] = torch.tensor(w, dtype=torch.float32,
                                                device=device)
    return _WINDOW_WEIGHTS[key]


def weighted_temporal_cross_entropy(logits, labels, n_class: int,
                                    weight_R: int, weight_r: float):
    """Per-frame CE averaged with triangular window weights.

    logits: (N, T, X, Y, C); labels: (N, T, X, Y).  Each frame's mean CE
    is weighted by w_t and the sum normalised by sum(w)
    (``network_ao.py:178-204``)."""
    w = temporal_window_weights(logits.shape[1], weight_R, weight_r,
                                logits.device)
    log_p, onehot = _onehot_log_p(logits, labels, n_class)
    per_frame = -torch.mean(torch.sum(onehot * log_p, dim=-1),
                            dim=(0, 2, 3))
    return torch.sum(w * per_frame) / torch.sum(w)


def centre_frame_cross_entropy(logits, labels, n_class: int):
    """CE on the centre frame only (``network_ao.py:382-392``,
    seq2seq=False)."""
    t = (logits.shape[1] - 1) // 2
    return softmax_cross_entropy(logits[:, t], labels[:, t], n_class)
