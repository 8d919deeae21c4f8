"""TransUNet, R50-ViT-B/16 — a hybrid CNN-transformer SA segmenter.

Chen et al., "TransUNet: Transformers Make Strong Encoders for Medical
Image Segmentation", arXiv:2102.04306; the published code is
``networks/vit_seg_modeling.py``, ``vit_seg_modeling_resnet_skip.py`` and
``get_r50_b16_config`` of github.com/Beckschen/TransUNet.  The modules
keep the published names, so a state dict of the published
``VisionTransformer`` has this module's keys:

- a ResNet-50 v2 stem and three stages (``transformer.embeddings.
  hybrid_model``): weight-standardised convolutions (:class:`StdConv2d`,
  eps 1e-5), GroupNorm(32, eps 1e-6), units (3, 4, 9) at widths
  256/512/1024, the stride on each stage's first 3x3 convolution, and a
  projection normalised by a GroupNorm of one group per channel at
  PyTorch's default eps (1e-5).  The stem's 3x3/2 max-pool has no
  padding (112 -> 55 at 224^2), and the first skip is zero-padded at the
  bottom and right to 56;
- a 1x1 patch embedding (1024 -> hidden) and learned position
  embeddings over the (grid/16)^2 tokens;
- pre-LN ViT-B blocks (LayerNorm eps 1e-6, exact GELU) and a final
  LayerNorm; the attention is ``F.scaled_dot_product_attention``, so it
  runs in kernels of its own;
- the cascaded upsampler: a 3x3 conv-BN-ReLU to 512, then per decoder
  block a x2 bilinear upsampling (``align_corners=True``), the skip
  (``n_skip`` of them) concatenated, and two 3x3 conv-BN-ReLU; then a
  3x3 head to the classes;
- one input channel, repeated to three.

Departures from the published code:

- eval mode only, with no training path: dropout is left out and the
  BatchNorms use their running statistics;
- the weight standardisation is folded once (:func:`fold_weight_std`,
  at load in ``infer/engine.py::SegmentationModel.from_transunet``)
  rather than computed in every forward; it is the same arithmetic on
  the same device, so the weights used are equal;
- the deploy feeds the port's SA input pipeline (percentile rescale,
  centred zero pad to the fixed ``img_size`` grid) instead of ACDC's
  resample to 224^2.

The plain reference is ``tests/transunet_plain.py`` (and the benchmark's
copy, ``benchmark/reference/transunet_sa.py``): the same forward in plain
operations, standardising in every forward and writing the attention
out in full.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

STD_EPS = 1e-5        # StdConv2d
GN_EPS = 1e-6         # the units' and the stem's GroupNorms
LN_EPS = 1e-6         # the transformer's LayerNorms


@dataclass(frozen=True)
class TransUNetConfig:
    """``get_r50_b16_config`` with the ACDC training script's
    ``n_classes`` (4) and ``patches.grid`` (img_size / 16)."""
    n_class: int = 4
    img_size: int = 224
    hidden_size: int = 768
    mlp_dim: int = 3072
    num_heads: int = 12
    num_layers: int = 12
    resnet_units: Sequence[int] = (3, 4, 9)
    width_factor: int = 1
    head_channels: int = 512
    decoder_channels: Sequence[int] = (256, 128, 64, 16)
    skip_channels: Sequence[int] = (512, 256, 64, 16)
    n_skip: int = 3

    @property
    def grid(self) -> int:
        """Tokens a side: the R50 reduces the grid by 16, the patch is
        1x1."""
        return self.img_size // 16


def standardise(w: torch.Tensor) -> torch.Tensor:
    """The published ``StdConv2d`` weight: each output filter less its
    mean, over its standard deviation (biased, eps 1e-5)."""
    v, m = torch.var_mean(w, dim=[1, 2, 3], keepdim=True, unbiased=False)
    return (w - m) / torch.sqrt(v + STD_EPS)


class StdConv2d(nn.Conv2d):
    """A weight-standardised convolution.  ``weight`` holds the published
    (raw) weight; :func:`fold_weight_std` stores its standardised form in
    the non-persistent buffer ``folded``, which the forward then uses."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("folded", None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.folded if self.folded is not None else \
            standardise(self.weight)
        return F.conv2d(x, w, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


@torch.no_grad()
def fold_weight_std(net: nn.Module) -> nn.Module:
    """Standardise every :class:`StdConv2d`'s weight once, where it lies
    (call it after moving the module); returns ``net``."""
    for m in net.modules():
        if isinstance(m, StdConv2d):
            m.folded = standardise(m.weight.detach())
    return net


def _conv1x1(cin, cout, stride=1):
    return StdConv2d(cin, cout, kernel_size=1, stride=stride, bias=False)


class PreActBottleneck(nn.Module):
    """The published unit (named "pre-activation", computed conv -> GN ->
    ReLU): 1x1, 3x3 (the stride), 1x1, and a projection where the stride
    or the width changes."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.gn1 = nn.GroupNorm(32, cmid, eps=GN_EPS)
        self.conv1 = _conv1x1(cin, cmid)
        self.gn2 = nn.GroupNorm(32, cmid, eps=GN_EPS)
        self.conv2 = StdConv2d(cmid, cmid, kernel_size=3, stride=stride,
                               padding=1, bias=False)
        self.gn3 = nn.GroupNorm(32, cout, eps=GN_EPS)
        self.conv3 = _conv1x1(cmid, cout)
        if stride != 1 or cin != cout:
            self.downsample = _conv1x1(cin, cout, stride)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if hasattr(self, "downsample"):
            residual = self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return F.relu(residual + y)


class ResNetV2(nn.Module):
    """The stem and three stages; returns the last stage's features and
    the skips, deepest first."""

    def __init__(self, units: Sequence[int], width_factor: int):
        super().__init__()
        width = int(64 * width_factor)
        self.width = width
        self.root = nn.Sequential(OrderedDict([
            ("conv", StdConv2d(3, width, kernel_size=7, stride=2,
                               padding=3, bias=False)),
            ("gn", nn.GroupNorm(32, width, eps=GN_EPS)),
            ("relu", nn.ReLU())]))
        stages = []
        cin = width
        for s, n in enumerate(units):
            cout, cmid = width * 4 * 2 ** s, width * 2 ** s
            stages.append((f"block{s + 1}", nn.Sequential(OrderedDict(
                (f"unit{i + 1}", PreActBottleneck(
                    cin if i == 0 else cout, cout, cmid,
                    2 if (s > 0 and i == 0) else 1))
                for i in range(n)))))
            cin = cout
        self.body = nn.Sequential(OrderedDict(stages))

    def forward(self, x: torch.Tensor):
        in_size = x.shape[2]
        features = []
        x = self.root(x)
        features.append(x)
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=0)
        for i, stage in enumerate(self.body[:-1]):
            x = stage(x)
            right = int(in_size / 4 / (i + 1))
            pad = right - x.shape[2]
            if not 0 <= pad < 3:
                raise ValueError(f"features of {tuple(x.shape)} at stage "
                                 f"{i + 1}, {right} expected")
            # the published zero pad at the bottom and right
            features.append(F.pad(x, (0, pad, 0, pad)) if pad else x)
        x = self.body[-1](x)
        return x, features[::-1]


class Embeddings(nn.Module):
    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        self.hybrid_model = ResNetV2(cfg.resnet_units, cfg.width_factor)
        self.patch_embeddings = nn.Conv2d(self.hybrid_model.width * 16,
                                          cfg.hidden_size, kernel_size=1)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, cfg.grid * cfg.grid, cfg.hidden_size))

    def forward(self, x: torch.Tensor):
        x, features = self.hybrid_model(x)
        x = self.patch_embeddings(x).flatten(2).transpose(-1, -2)
        return x + self.position_embeddings, features


class Attention(nn.Module):
    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        h = cfg.hidden_size
        self.heads = cfg.num_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.out = nn.Linear(h, h)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        B, n, h = x.shape
        return x.view(B, n, self.heads, h // self.heads).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (self._split(lin(x))
                   for lin in (self.query, self.key, self.value))
        ctx = F.scaled_dot_product_attention(q, k, v)
        return self.out(ctx.transpose(1, 2).flatten(2))


class Mlp(nn.Module):
    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        self.attention_norm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.ffn_norm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.ffn = Mlp(cfg)
        self.attn = Attention(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class Encoder(nn.Module):
    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        self.layer = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.encoder_norm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.layer:
            x = block(x)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, x: torch.Tensor):
        x, features = self.embeddings(x)
        return self.encoder(x), features


def _conv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    """The published ``Conv2dReLU``: a 3x3 convolution without bias, a
    BatchNorm, a ReLU (keys ``.0``, ``.1``)."""
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int):
        super().__init__()
        self.conv1 = _conv_bn_relu(cin + skip, cout)
        self.conv2 = _conv_bn_relu(cout, cout)

    def forward(self, x: torch.Tensor, skip=None) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class DecoderCup(nn.Module):
    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        self.n_skip = cfg.n_skip
        self.conv_more = _conv_bn_relu(cfg.hidden_size, cfg.head_channels)
        outs = list(cfg.decoder_channels)
        ins = [cfg.head_channels] + outs[:-1]
        skips = [c if i < cfg.n_skip else 0
                 for i, c in enumerate(cfg.skip_channels)]
        self.blocks = nn.ModuleList(DecoderBlock(i, o, s)
                                    for i, o, s in zip(ins, outs, skips))

    def forward(self, tokens: torch.Tensor,
                features: List[torch.Tensor]) -> torch.Tensor:
        B, n, hidden = tokens.shape
        side = int(round(n ** 0.5))
        x = tokens.transpose(1, 2).reshape(B, hidden, side, side)
        x = self.conv_more(x)
        for i, block in enumerate(self.blocks):
            x = block(x, features[i] if i < self.n_skip else None)
        return x


class TransUNet(nn.Module):
    """The published ``VisionTransformer`` (R50 hybrid), eval mode: NCHW
    images of one (or three) channels at ``cfg.img_size`` squared ->
    NCHW float32 logits."""

    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        self.cfg = cfg
        self.transformer = Transformer(cfg)
        self.decoder = DecoderCup(cfg)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(cfg.decoder_channels[-1], cfg.n_class, 3, padding=1),
            nn.Identity())

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``compute_dtype`` other than float32 runs the forward under
        autocast to it (the engines' low-precision option)."""
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        with torch.autocast(x.device.type, dtype=compute_dtype,
                            enabled=compute_dtype != torch.float32):
            tokens, features = self.transformer(x)
            logits = self.segmentation_head(self.decoder(tokens, features))
        return logits.float()
