"""The FCN segmenter — the SA/LA model.

Counterpart of ``ukbb_cardiac_tpu/models/fcn.py`` (``build_FCN`` in
``common/network.py:170-230``): a VGG-style encoder with stride-2
downsampling, every level projected to ``same_dim`` channels by a 1x1
conv, upsampled to full resolution with fixed bilinear transposed convs
of factor 2^l, merged, and a two-layer 1x1 head producing class logits.

NCHW inside; :func:`apply_fcn` takes (N, X, Y, C) images and returns
(N, X, Y, n_class) logits like the JAX function.  The ResNet-FCN is not
ported yet; the U-Net is ``models/unet.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch
from torch import nn

from ukbb_cardiac_tpu_torch.models import layers as L


@dataclass(frozen=True)
class FCNConfig:
    n_class: int = 4
    n_level: int = 5
    n_filter: Sequence[int] = (16, 32, 64, 128, 256)
    n_block: Sequence[int] = (2, 2, 3, 3, 3)
    same_dim: int = 32
    fc: int = 64
    in_ch: int = 1


class FCN(nn.Module):
    """Eval-mode FCN; weights come from the JAX package's bundles through
    :func:`ukbb_cardiac_tpu_torch.ckpt.convert.fcn_state_dict_from_jax`."""

    def __init__(self, cfg: FCNConfig):
        super().__init__()
        self.cfg = cfg
        levels, in_ch = [], cfg.in_ch
        for l in range(cfg.n_level):
            blocks = []
            for i in range(cfg.n_block[l]):
                stride = 2 if (l > 0 and i == 0) else 1
                blocks.append(L.ConvBN(in_ch, cfg.n_filter[l], 3, stride))
                in_ch = cfg.n_filter[l]
            levels.append(nn.ModuleList(blocks))
        self.levels = nn.ModuleList(levels)
        self.same_dim = nn.ModuleList(
            [L.ConvBN(cfg.n_filter[l], cfg.same_dim, 1)
             for l in range(cfg.n_level)])
        self.fc = nn.ModuleList([
            L.ConvBN(cfg.same_dim * cfg.n_level, cfg.fc, 1),
            L.ConvBN(cfg.fc, cfg.fc, 1)])
        self.out = nn.Conv2d(cfg.fc, cfg.n_class, 1, bias=True)

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NCHW image -> per-level NCHW features (level 0 at full size)."""
        feats = []
        for blocks in self.levels:
            for block in blocks:
                x = block(x)
            feats.append(x)
        return feats

    def head(self, feats: List[torch.Tensor], fused: bool) -> torch.Tensor:
        """Same-dim projections -> multiscale merge -> fc head
        (``fcn.py:93-157``).  Returns NCHW float32 logits.

        ``fused=False`` is the literal concat of ``network.py:207-221``;
        ``fused=True`` applies each level's slice of fc1 before the
        upsample (the two commute) and sums the partial products in
        float32.  Both compute the same function.
        """
        fc1, fc2 = self.fc
        sd = self.cfg.same_dim
        if fused:
            z = None
            for l, f in enumerate(feats):
                f = self.same_dim[l](f)
                y = L.conv2d(f, fc1.weight[:, l * sd:(l + 1) * sd])
                if l > 0:
                    y = L.transpose_upsample2d(y, 2 ** l)
                y = y.float()
                z = y if z is None else z + y
            x = torch.relu(fc1.bn(z)).to(feats[0].dtype)
        else:
            ups = []
            for l, f in enumerate(feats):
                f = self.same_dim[l](f)
                if l > 0:
                    f = L.transpose_upsample2d(f, 2 ** l)
                ups.append(f)
            x = fc1(torch.cat(ups, dim=1))
        x = fc2(x)
        return L.conv2d(x, self.out.weight, bias=self.out.bias).float()

    def forward(self, x: torch.Tensor, fused_head: bool = False
                ) -> torch.Tensor:
        """NCHW image -> NCHW float32 logits."""
        return self.head(self.encode(x), fused_head)


def apply_fcn(model: FCN, image: torch.Tensor, compute_dtype=torch.float32,
              fused_head: bool = False) -> torch.Tensor:
    """Forward pass: image (N, X, Y, C) -> logits (N, X, Y, n_class)
    float32, as ``fcn.apply_fcn`` in inference mode.  X and Y must be
    multiples of 2^(n_level-1)."""
    return model(nchw(image, compute_dtype), fused_head).permute(0, 2, 3, 1)


def nchw(image: torch.Tensor, dtype) -> torch.Tensor:
    """(N, X, Y, C) -> NCHW ``dtype`` with standard strides.  A plain
    permute of a one-channel image has ambiguous strides that make
    ``F.conv2d`` return channels-last features."""
    return image.permute(0, 3, 1, 2).to(dtype).clone(
        memory_format=torch.contiguous_format)


def prob_and_pred(logits: torch.Tensor):
    """Softmax probability and argmax prediction over the last axis
    (``fcn.py:281``)."""
    prob = torch.softmax(logits, dim=-1)
    pred = torch.argmax(logits, dim=-1).to(torch.int32)
    return prob, pred
