"""The FCN and ResNet-FCN segmenters — the SA/LA models.

Counterpart of ``ukbb_cardiac_tpu/models/fcn.py`` (``build_FCN`` in
``common/network.py:170-230``): a VGG-style encoder with stride-2
downsampling, every level projected to ``same_dim`` channels by a 1x1
conv, upsampled to full resolution with fixed bilinear transposed convs
of factor 2^l, merged, and a two-layer 1x1 head producing class logits.

The ResNet-FCN (``build_ResNet``, ``network.py:233-300``) keeps the
plain conv blocks at levels 0-1, has pre-activation residual units from
level 2, and shares the FCN's multiscale head.

NCHW inside; :func:`apply_fcn` takes (N, X, Y, C) images and returns
(N, X, Y, n_class) logits like the JAX function.  ``train=True`` runs the
training forward: batch-statistics BatchNorm whose moving statistics
update in place, and by default the sum-of-levels head; in data-parallel
training the statistics are the global batch's, over the process group
that ``layers.batch_norm_group`` sets on every BatchNorm for the
forward.  The U-Net is ``models/unet.py``.
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


@dataclass(frozen=True)
class ResNetConfig(FCNConfig):
    use_bottleneck: bool = False


class FCN(nn.Module):
    """The FCN.  Weights come from the JAX package's bundles through
    :func:`ukbb_cardiac_tpu_torch.ckpt.convert.fcn_state_dict_from_jax`,
    or from :func:`init_weights`."""

    def __init__(self, cfg: FCNConfig):
        super().__init__()
        self.cfg = cfg
        self.levels = nn.ModuleList(self._encoder())
        self._init_head()

    def _conv_levels(self, n: int, in_ch: int):
        """The first ``n`` levels of plain conv blocks (stride 2 at each
        level's first block from level 1)."""
        levels = []
        for l in range(n):
            blocks = []
            for i in range(self.cfg.n_block[l]):
                stride = 2 if (l > 0 and i == 0) else 1
                blocks.append(L.ConvBN(in_ch, self.cfg.n_filter[l], 3,
                                       stride))
                in_ch = self.cfg.n_filter[l]
            levels.append(nn.ModuleList(blocks))
        return levels

    def _encoder(self):
        return self._conv_levels(self.cfg.n_level, self.cfg.in_ch)

    def _init_head(self):
        cfg = self.cfg
        self.same_dim = nn.ModuleList(
            [L.ConvBN(cfg.n_filter[l], cfg.same_dim, 1)
             for l in range(cfg.n_level)])
        self.fc = nn.ModuleList([
            L.ConvBN(cfg.same_dim * cfg.n_level, cfg.fc, 1),
            L.ConvBN(cfg.fc, cfg.fc, 1)])
        self.out = nn.Conv2d(cfg.fc, cfg.n_class, 1, bias=True)

    def encode(self, x: torch.Tensor, train: bool = False
               ) -> List[torch.Tensor]:
        """NCHW image -> per-level NCHW features (level 0 at full size)."""
        feats = []
        for blocks in self.levels:
            for block in blocks:
                x = block(x, train)
            feats.append(x)
        return feats

    def head(self, feats: List[torch.Tensor], fused: bool,
             train: bool = False) -> torch.Tensor:
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
                f = self.same_dim[l](f, train)
                y = L.conv2d(f, fc1.weight[:, l * sd:(l + 1) * sd])
                if l > 0:
                    y = L.transpose_upsample2d(y, 2 ** l)
                y = y.float()
                z = y if z is None else z + y
            x = torch.relu(fc1.bn(z, train)).to(feats[0].dtype)
        else:
            ups = []
            for l, f in enumerate(feats):
                f = self.same_dim[l](f, train)
                if l > 0:
                    f = L.transpose_upsample2d(f, 2 ** l)
                ups.append(f)
            x = fc1(torch.cat(ups, dim=1), train)
        x = fc2(x, train)
        return L.conv2d(x, self.out.weight, bias=self.out.bias).float()

    def forward(self, x: torch.Tensor, fused_head: bool | None = None,
                train: bool = False) -> torch.Tensor:
        """NCHW image -> NCHW float32 logits.  ``fused_head`` None picks
        the sum-of-levels head when training and the concat head
        otherwise, as ``fcn.apply_fcn`` does."""
        if fused_head is None:
            fused_head = train
        return self.head(self.encode(x, train), fused_head, train)


class ResNetFCN(FCN):
    """The ResNet-FCN (``fcn.init_resnet`` / ``apply_resnet``): plain conv
    blocks at levels 0-1, then per level ``n_block`` residual (or
    bottleneck) units, the first with stride 2; the FCN's head."""

    cfg: ResNetConfig

    def _encoder(self):
        cfg = self.cfg
        levels = self._conv_levels(2, cfg.in_ch)
        in_ch = cfg.n_filter[1]
        for l in range(2, cfg.n_level):
            units = []
            for i in range(cfg.n_block[l]):
                units.append(L.ResidualUnit(in_ch, cfg.n_filter[l],
                                            2 if i == 0 else 1,
                                            cfg.use_bottleneck))
                in_ch = cfg.n_filter[l]
            levels.append(nn.ModuleList(units))
        return levels


def init_weights(model: nn.Module,
                 generator: torch.Generator | None = None) -> nn.Module:
    """Initialise a freshly built FCN / ResNet-FCN as ``init_fcn`` /
    ``init_resnet`` do: every conv kernel Glorot-uniform from
    ``generator``, BN gamma 1 / beta 0 / moving mean 0 / variance 1, the
    output bias 0.  The draws are torch's: parity with the JAX package
    comes from converted weights, never from shared seeds."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 4:
                L.glorot_uniform_(p, generator)
            elif name.endswith("gamma"):
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in model.named_buffers():
            b.fill_(1.0 if name.endswith("moving_variance") else 0.0)
    return model


def apply_fcn(model: FCN, image: torch.Tensor, compute_dtype=torch.float32,
              fused_head: bool | None = None,
              train: bool = False) -> torch.Tensor:
    """Forward pass: image (N, X, Y, C) -> logits (N, X, Y, n_class)
    float32, as ``fcn.apply_fcn`` / ``apply_resnet``.  X and Y must be
    multiples of 2^(n_level-1).  ``train`` updates the BN moving
    statistics in place (the JAX function's ``new_state``)."""
    return model(nchw(image, compute_dtype), fused_head,
                 train).permute(0, 2, 3, 1)


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
