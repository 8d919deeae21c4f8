"""U-Net and Temporal (2D+t) U-Net — the aortic segmenters.

Counterpart of ``ukbb_cardiac_tpu/models/unet.py`` (``common/network_ao.py``
``UNet``, ``Temporal_UNet``): an encoder/decoder with stride-2 downsampling,
TF-SAME transposed-conv upsampling and skip concatenation ``[skip, up]``.
The temporal variant uses 3D convs with stride (1, 2, 2), so time keeps
its full resolution.  The network also returns the ``conv0_up`` features,
the tensor the UNet-LSTM head consumes.

NCHW (NCDHW, time as depth) inside; :func:`apply_unet` and
:func:`apply_temporal_unet` take and return the JAX package's
channels-last layouts.  Train-mode BatchNorm takes the global batch's
statistics under ``layers.batch_norm_group`` (data-parallel training).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from ukbb_cardiac_tpu_torch.models import layers as L
from ukbb_cardiac_tpu_torch.models.fcn import nchw


@dataclass(frozen=True)
class UNetConfig:
    n_class: int = 3
    n_level: int = 5
    n_filter: Sequence[int] = (16, 32, 64, 128, 256)
    n_block: Sequence[int] = (2, 2, 2, 2, 2)
    in_ch: int = 1


class UNet(nn.Module):
    """U-Net; weights come from the JAX package's bundles through
    :func:`ukbb_cardiac_tpu_torch.ckpt.convert.unet_from_jax` or from
    ``models.fcn.init_weights``.  ``dims`` 3 makes it the temporal
    U-Net."""

    def __init__(self, cfg: UNetConfig, dims: int = 2):
        super().__init__()
        self.cfg = cfg
        self.dims = dims
        down, in_ch = [], cfg.in_ch
        for l in range(cfg.n_level):
            blocks = []
            for i in range(cfg.n_block[l]):
                blocks.append(L.ConvBN(in_ch, cfg.n_filter[l], 3,
                                       self._stride(l > 0 and i == 0), dims))
                in_ch = cfg.n_filter[l]
            down.append(nn.ModuleList(blocks))
        self.down = nn.ModuleList(down)
        # decoder levels n_level-2 .. 0: a transposed conv, then n_block
        # convs over the concatenation [skip, up]
        up = []
        for l in range(cfg.n_level - 2, -1, -1):
            blocks = [L.ConvBN(cfg.n_filter[l + 1], cfg.n_filter[l], 3,
                               self._stride(True), dims, transpose=True)]
            in_ch = 2 * cfg.n_filter[l]
            for i in range(cfg.n_block[l]):
                blocks.append(L.ConvBN(in_ch, cfg.n_filter[l], 3,
                                       self._stride(False), dims))
                in_ch = cfg.n_filter[l]
            up.append(nn.ModuleList(blocks))
        self.up = nn.ModuleList(up)
        self.out_weight = nn.Parameter(
            torch.zeros((cfg.n_class, cfg.n_filter[0]) + (1,) * dims))
        self.out_bias = nn.Parameter(torch.zeros(cfg.n_class))

    def _stride(self, down: bool):
        s = 2 if down else 1
        return s if self.dims == 2 else (1, s, s)

    def forward(self, x: torch.Tensor, train: bool = False):
        """NC[D]HW image -> (float32 logits, ``conv0_up`` features in the
        input's dtype), both NC[D]HW.  ``train`` normalises with batch
        statistics and updates the BN moving statistics in place."""
        skips = []
        for blocks in self.down:
            for block in blocks:
                x = block(x, train)
            skips.append(x)
        for blocks, l in zip(self.up, range(self.cfg.n_level - 2, -1, -1)):
            x = torch.cat([skips[l], blocks[0](x, train)], dim=1)
            for block in blocks[1:]:
                x = block(x, train)
        conv = L.conv2d if self.dims == 2 else L.conv3d
        logits = conv(x, self.out_weight, bias=self.out_bias).float()
        return logits, x


def apply_unet(model: UNet, image: torch.Tensor,
               compute_dtype=torch.float32, train: bool = False):
    """(N, X, Y, C) image -> (logits (N, X, Y, n_class) float32, features
    (N, X, Y, n_filter[0])), as ``unet.apply_unet``."""
    logits, feats = model(nchw(image, compute_dtype), train)
    return logits.permute(0, 2, 3, 1), feats.permute(0, 2, 3, 1)


def apply_temporal_unet(model: UNet, image: torch.Tensor,
                        compute_dtype=torch.float32, train: bool = False):
    """(N, T, X, Y, C) image -> (logits (N, T, X, Y, n_class) float32,
    features), as ``unet.apply_temporal_unet``."""
    x = image.permute(0, 4, 1, 2, 3).to(compute_dtype).clone(
        memory_format=torch.contiguous_format)
    logits, feats = model(x, train)
    return logits.permute(0, 2, 3, 4, 1), feats.permute(0, 2, 3, 4, 1)
