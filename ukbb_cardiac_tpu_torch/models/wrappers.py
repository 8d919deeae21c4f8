"""The UNet-LSTM: U-Net features per frame, then a (Bi)ConvLSTM over time.

Counterpart of ``ukbb_cardiac_tpu/models/wrappers.py::unet_lstm_features``
and the inference half of ``unet_lstm_model`` (``network_ao.py:322-399``).
The time axis folds into the batch for the U-Net.
"""

from __future__ import annotations

import torch
from torch import nn

from ukbb_cardiac_tpu_torch.models.unet import UNet, apply_unet


def unet_lstm_features(unet: UNet, images: torch.Tensor,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """(N, T, X, Y, C) images -> (N, T, X, Y, n_filter[0]) ``conv0_up``
    features, T folded into the U-Net's batch."""
    N, T = images.shape[:2]
    _, feats = apply_unet(unet, images.flatten(0, 1), compute_dtype)
    return feats.reshape(N, T, *feats.shape[1:])


class UNetLSTM(nn.Module):
    """U-Net backbone + ConvLSTM head (``ConvLSTM`` or ``BiConvLSTM``)."""

    def __init__(self, unet: UNet, lstm: nn.Module):
        super().__init__()
        self.unet = unet
        self.lstm = lstm

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        """(N, T, C, X, Y) frames in the compute dtype -> (N, T, n_class,
        X, Y) float32 logits."""
        N, T = seq.shape[:2]
        _, feats = self.unet(seq.flatten(0, 1))
        return self.lstm(feats.view(N, T, *feats.shape[1:]))
