"""The UNet-LSTM module: the U-Net's ``conv0_up`` features of every frame
through the bidirectional ConvLSTM.

Counterpart of ``ukbb_cardiac_tpu/models/wrappers.py``
(``network_ao.py:322-399``, ``UNet_LSTM_Model``), the forward alone.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.port.models.convlstm import BiConvLSTM
from benchmark.reference.port.models.unet import UNet


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
