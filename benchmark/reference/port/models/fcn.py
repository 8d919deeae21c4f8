"""The FCN segmenter — the SA model.

Counterpart of ``ukbb_cardiac_tpu/models/fcn.py`` (``build_FCN`` in
``common/network.py:170-230``): a VGG-style encoder with stride-2
downsampling, every level projected to ``same_dim`` channels by a 1x1
conv, upsampled to full resolution with fixed bilinear transposed convs
of factor 2^l, merged, and a two-layer 1x1 head producing class logits.
NCHW inside.  The U-Net is ``models/unet.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch
from torch import nn

from benchmark.reference.port.models import layers as L


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
    """The FCN.  Weights come from the JAX package's bundles through
    :func:`benchmark.reference.port.ckpt.convert.fcn_state_dict_from_jax`,
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
