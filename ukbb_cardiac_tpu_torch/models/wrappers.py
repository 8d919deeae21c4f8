"""Model heads: loss + prob + pred over the aortic backbones, and the
UNet-LSTM module.

Counterpart of ``ukbb_cardiac_tpu/models/wrappers.py``
(``network_ao.py:138-211,322-399``: ``UNet_Model``,
``Temporal_UNet_Model``, ``UNet_LSTM_Model``).  The JAX wrappers return
``(loss, prob, pred, new_state)``; here the modules own their BN buffers,
a training forward updates them in place, and the wrappers return
``(loss, prob, pred)``.  Inputs and logits are channels-last, as in the
JAX package.

In bf16 the activations are bfloat16 while the parameters, BN
statistics, logits and loss stay float32, and the ConvLSTM keeps its
cell state float32 (``models/convlstm.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ukbb_cardiac_tpu_torch.models import losses
from ukbb_cardiac_tpu_torch.models.convlstm import (BiConvLSTM,
                                                    apply_biconv_lstm,
                                                    apply_conv_lstm)
from ukbb_cardiac_tpu_torch.models.fcn import prob_and_pred
from ukbb_cardiac_tpu_torch.models.unet import (UNet, apply_temporal_unet,
                                                apply_unet)


def unet_model(net: UNet, images: torch.Tensor, labels: torch.Tensor,
               train: bool = False, compute_dtype=None):
    """2D U-Net + softmax CE (``network_ao.py:138-161``).  images (N, X,
    Y, C), labels (N, X, Y)."""
    logits, _ = apply_unet(net, images, compute_dtype or torch.float32,
                           train)
    loss = losses.softmax_cross_entropy(logits, labels, net.cfg.n_class)
    prob, pred = prob_and_pred(logits)
    return loss, prob, pred


def temporal_unet_model(net: UNet, images: torch.Tensor,
                        labels: torch.Tensor, train: bool = False,
                        weight_R: int = 1, weight_r: float = 0.0,
                        compute_dtype=None):
    """2D+t U-Net + triangular-weighted temporal CE
    (``network_ao.py:164-211``).  images (N, T, X, Y, C), labels (N, T, X,
    Y)."""
    logits, _ = apply_temporal_unet(net, images,
                                    compute_dtype or torch.float32, train)
    loss = losses.weighted_temporal_cross_entropy(
        logits, labels, net.cfg.n_class, weight_R, weight_r)
    prob, pred = prob_and_pred(logits)
    return loss, prob, pred


def unet_lstm_features(unet: UNet, images: torch.Tensor,
                       compute_dtype=torch.float32,
                       train: bool = False) -> torch.Tensor:
    """(N, T, X, Y, C) images -> (N, T, X, Y, n_filter[0]) ``conv0_up``
    features, T folded into the U-Net's batch
    (``network_ao.py:332-345``)."""
    N, T = images.shape[:2]
    _, feats = apply_unet(unet, images.flatten(0, 1), compute_dtype, train)
    return feats.reshape(N, T, *feats.shape[1:])


class UNetLSTM(nn.Module):
    """U-Net backbone + ConvLSTM head (``ConvLSTM`` or ``BiConvLSTM``)."""

    def __init__(self, unet: UNet, lstm: nn.Module):
        super().__init__()
        self.unet = unet
        self.lstm = lstm

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        """(N, T, C, X, Y) frames in the compute dtype -> (N, T, n_class,
        X, Y) float32 logits (inference: BN moving statistics)."""
        N, T = seq.shape[:2]
        _, feats = self.unet(seq.flatten(0, 1))
        return self.lstm(feats.view(N, T, *feats.shape[1:]))


def unet_lstm_model(net: UNetLSTM, images: torch.Tensor,
                    labels: torch.Tensor, train_unet: bool = False,
                    seq2seq: bool = True, weight_R: int = 1,
                    weight_r: float = 0.0, compute_dtype=None):
    """UNet features -> (Bi)ConvLSTM -> per-frame logits + loss
    (``network_ao.py:322-399``).  images (N, T, X, Y, C), labels (N, T, X,
    Y); ``net.lstm`` decides the direction.

    Without ``train_unet`` the U-Net runs as in inference (BN moving
    statistics, left unchanged) and outside autograd: the two-phase
    trainer never updates it, so no gradient is taken through it."""
    dtype = compute_dtype or torch.float32
    if train_unet:
        features = unet_lstm_features(net.unet, images, dtype, True)
    else:
        with torch.no_grad():
            features = unet_lstm_features(net.unet, images, dtype)
    if isinstance(net.lstm, BiConvLSTM):
        logits = apply_biconv_lstm(net.lstm, features)
    else:
        logits = apply_conv_lstm(net.lstm, features)
    n_class = net.unet.cfg.n_class
    if seq2seq:
        loss = losses.weighted_temporal_cross_entropy(logits, labels,
                                                      n_class, weight_R,
                                                      weight_r)
    else:
        loss = losses.centre_frame_cross_entropy(logits, labels, n_class)
    prob, pred = prob_and_pred(logits)
    return loss, prob, pred
