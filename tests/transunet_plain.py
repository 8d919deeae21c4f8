"""The plain reference of TransUNet R50-ViT-B/16 for the test suite.

The published forward (Chen et al., arXiv:2102.04306;
``networks/vit_seg_modeling.py`` and ``vit_seg_modeling_resnet_skip.py``
of github.com/Beckschen/TransUNet) written out in plain ``torch``
operations over a dict of tensors named as the published
``VisionTransformer``'s state dict: every convolution's weight
standardised in every forward, ``F.group_norm``, ``F.layer_norm``,
``softmax(Q K^T / sqrt(d)) V`` computed in full (no fused attention),
``F.interpolate`` for the bilinear (``align_corners=True``) upsampling,
eval-mode BatchNorm from its running statistics.  Float32, with both
TF32 flags off.  It imports nothing of the port and no JAX.

``cfg`` is a dict with the keys of the port's ``TransUNetConfig``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

R50 = "transformer.embeddings.hybrid_model."


def _units(cfg):
    """(stage name, unit name, cin, cout, cmid, stride) of every unit."""
    width = 64 * cfg["width_factor"]
    cin = width
    for s, n in enumerate(cfg["resnet_units"]):
        cout, cmid = width * 4 * 2 ** s, width * 2 ** s
        for i in range(n):
            yield (f"block{s + 1}", f"unit{i + 1}", cin if i == 0 else cout,
                   cout, cmid, 2 if (s > 0 and i == 0) else 1)
        cin = cout


def shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every tensor's name and shape, as the published module holds them
    (BatchNorm's ``num_batches_tracked`` included)."""
    out = {}
    width, h = 64 * cfg["width_factor"], cfg["hidden_size"]
    grid = cfg["img_size"] // 16
    out["transformer.embeddings.position_embeddings"] = (1, grid * grid, h)
    out[R50 + "root.conv.weight"] = (width, 3, 7, 7)
    out[R50 + "root.gn.weight"] = out[R50 + "root.gn.bias"] = (width,)
    for stage, unit, cin, cout, cmid, stride in _units(cfg):
        u = f"{R50}body.{stage}.{unit}."
        for name, c in (("gn1", cmid), ("gn2", cmid), ("gn3", cout)):
            out[u + name + ".weight"] = out[u + name + ".bias"] = (c,)
        out[u + "conv1.weight"] = (cmid, cin, 1, 1)
        out[u + "conv2.weight"] = (cmid, cmid, 3, 3)
        out[u + "conv3.weight"] = (cout, cmid, 1, 1)
        if stride != 1 or cin != cout:
            out[u + "downsample.weight"] = (cout, cin, 1, 1)
            out[u + "gn_proj.weight"] = out[u + "gn_proj.bias"] = (cout,)
    out["transformer.embeddings.patch_embeddings.weight"] = (
        h, width * 16, 1, 1)
    out["transformer.embeddings.patch_embeddings.bias"] = (h,)
    for i in range(cfg["num_layers"]):
        b = f"transformer.encoder.layer.{i}."
        for norm in ("attention_norm", "ffn_norm"):
            out[b + norm + ".weight"] = out[b + norm + ".bias"] = (h,)
        out[b + "ffn.fc1.weight"] = (cfg["mlp_dim"], h)
        out[b + "ffn.fc1.bias"] = (cfg["mlp_dim"],)
        out[b + "ffn.fc2.weight"] = (h, cfg["mlp_dim"])
        out[b + "ffn.fc2.bias"] = (h,)
        for lin in ("query", "key", "value", "out"):
            out[b + f"attn.{lin}.weight"] = (h, h)
            out[b + f"attn.{lin}.bias"] = (h,)
    out["transformer.encoder.encoder_norm.weight"] = (h,)
    out["transformer.encoder.encoder_norm.bias"] = (h,)

    def conv_bn(prefix, cin, cout):
        out[prefix + ".0.weight"] = (cout, cin, 3, 3)
        for k in ("weight", "bias", "running_mean", "running_var"):
            out[prefix + f".1.{k}"] = (cout,)
        out[prefix + ".1.num_batches_tracked"] = ()

    conv_bn("decoder.conv_more", h, cfg["head_channels"])
    outs = list(cfg["decoder_channels"])
    ins = [cfg["head_channels"]] + outs[:-1]
    for i, (cin, cout) in enumerate(zip(ins, outs)):
        skip = cfg["skip_channels"][i] if i < cfg["n_skip"] else 0
        conv_bn(f"decoder.blocks.{i}.conv1", cin + skip, cout)
        conv_bn(f"decoder.blocks.{i}.conv2", cout, cout)
    out["segmentation_head.0.weight"] = (cfg["n_class"], outs[-1], 3, 3)
    out["segmentation_head.0.bias"] = (cfg["n_class"],)
    return out


def random_weights(cfg, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights of every tensor of :func:`shapes`, drawn so
    that the argmax is not constant: convolutions and linears at unit
    variance over their fan-in (He for the decoder), norms' scales near
    1 and shifts near 0, the BatchNorms' running statistics spread, and
    the head's bias set by :func:`calibrate_head` on a seeded disk
    image."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in shapes(cfg).items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.int64)
            continue
        r = torch.randn(shape, generator=g)
        if len(shape) >= 2 and "position" not in name:
            fan_in = math.prod(shape[1:])
            gain = 2.0 if name.startswith(("decoder", "segmentation")) else 1.0
            out[name] = r * math.sqrt(gain / fan_in)
        elif name.endswith("running_var"):
            out[name] = 1.0 + 0.1 * r.abs()
        elif name.endswith(("norm.weight", "gn1.weight", "gn2.weight",
                            "gn3.weight", "gn_proj.weight", "gn.weight",
                            ".1.weight")):
            out[name] = 1.0 + 0.1 * r
        else:
            out[name] = 0.1 * r
    S = cfg["img_size"]
    xx, yy = torch.meshgrid(torch.arange(S), torch.arange(S), indexing="ij")
    r2 = (xx - S / 2.0) ** 2 + (yy - S / 2.0) ** 2
    disk = torch.where(r2 <= (S / 6.0) ** 2, 0.9, 0.2)
    calibrate_head(out, cfg, (disk + 0.05 * torch.randn(
        (S, S), generator=g))[None, None])
    return out


def calibrate_head(p: Dict[str, torch.Tensor], cfg, image: torch.Tensor
                   ) -> None:
    """Set the head's bias to minus each class's mean logit over
    ``image`` (NCHW): with random weights the features' mean otherwise
    hands one class a lead everywhere, and the argmax barely follows the
    image."""
    bias = "segmentation_head.0.bias"
    p[bias] = torch.zeros_like(p[bias])
    with torch.no_grad():
        p[bias] = -forward(p, cfg, image.to(p[bias].device)).mean(
            dim=(0, 2, 3))


def _std(w: torch.Tensor) -> torch.Tensor:
    v, m = torch.var_mean(w, dim=[1, 2, 3], keepdim=True, unbiased=False)
    return (w - m) / torch.sqrt(v + 1e-5)


def _gn(x, p, name, groups, eps=1e-6):
    return F.group_norm(x, groups, p[name + ".weight"], p[name + ".bias"],
                        eps)


def _unit(x, p, u, cin, cout, stride):
    residual = x
    if stride != 1 or cin != cout:
        residual = F.group_norm(F.conv2d(x, _std(p[u + "downsample.weight"]),
                                         stride=stride), cout,
                                p[u + "gn_proj.weight"],
                                p[u + "gn_proj.bias"], 1e-5)
    y = F.relu(_gn(F.conv2d(x, _std(p[u + "conv1.weight"])), p, u + "gn1",
                   32))
    y = F.relu(_gn(F.conv2d(y, _std(p[u + "conv2.weight"]), stride=stride,
                            padding=1), p, u + "gn2", 32))
    y = _gn(F.conv2d(y, _std(p[u + "conv3.weight"])), p, u + "gn3", 32)
    return F.relu(residual + y)


def _resnet(x, p, cfg):
    in_size = x.shape[2]
    x = F.conv2d(x, _std(p[R50 + "root.conv.weight"]), stride=2, padding=3)
    x = F.relu(_gn(x, p, R50 + "root.gn", 32))
    features = [x]
    x = F.max_pool2d(x, 3, 2, 0)
    n_stages = len(cfg["resnet_units"])
    stage = 0
    for name, unit, cin, cout, cmid, stride in _units(cfg):
        s = int(name[len("block"):]) - 1
        if s != stage:
            # a stage ended: its output, zero-padded at the bottom and
            # right to in_size / 4 / (stage + 1), is a skip
            features.append(_pad_skip(x, int(in_size / 4 / (stage + 1))))
            stage = s
        x = _unit(x, p, f"{R50}body.{name}.{unit}.", cin, cout, stride)
    assert stage == n_stages - 1
    return x, features[::-1]


def _pad_skip(x, right):
    feat = torch.zeros(x.shape[:2] + (right, right), dtype=x.dtype,
                       device=x.device)
    feat[:, :, :x.shape[2], :x.shape[3]] = x
    return feat


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], 1e-6)


def _linear(x, p, name):
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


def _attention(x, p, b, heads):
    B, n, h = x.shape
    d = h // heads

    def split(t):
        return t.reshape(B, n, heads, d).permute(0, 2, 1, 3)

    q, k, v = (split(_linear(x, p, b + f"attn.{lin}"))
               for lin in ("query", "key", "value"))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
    return _linear(ctx.permute(0, 2, 1, 3).reshape(B, n, h), p,
                   b + "attn.out")


def _conv_bn_relu(x, p, prefix):
    x = F.conv2d(x, p[prefix + ".0.weight"], padding=1)
    x = F.batch_norm(x, p[prefix + ".1.running_mean"],
                     p[prefix + ".1.running_var"], p[prefix + ".1.weight"],
                     p[prefix + ".1.bias"], False, 0.0, 1e-5)
    return F.relu(x)


def forward(p: Dict[str, torch.Tensor], cfg, x: torch.Tensor
            ) -> torch.Tensor:
    """NCHW images of one channel at ``img_size`` squared -> NCHW float32
    logits."""
    x = x.repeat(1, 3, 1, 1)
    x, features = _resnet(x, p, cfg)
    x = F.conv2d(x, p["transformer.embeddings.patch_embeddings.weight"],
                 p["transformer.embeddings.patch_embeddings.bias"])
    x = x.flatten(2).transpose(-1, -2) + \
        p["transformer.embeddings.position_embeddings"]
    for i in range(cfg["num_layers"]):
        b = f"transformer.encoder.layer.{i}."
        x = x + _attention(_ln(x, p, b + "attention_norm"), p, b,
                           cfg["num_heads"])
        y = _linear(_ln(x, p, b + "ffn_norm"), p, b + "ffn.fc1")
        x = x + _linear(F.gelu(y), p, b + "ffn.fc2")
    x = _ln(x, p, "transformer.encoder.encoder_norm")
    B, n, h = x.shape
    side = int(round(math.sqrt(n)))
    x = x.permute(0, 2, 1).reshape(B, h, side, side)
    x = _conv_bn_relu(x, p, "decoder.conv_more")
    for i in range(len(cfg["decoder_channels"])):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        if i < cfg["n_skip"]:
            x = torch.cat([x, features[i]], dim=1)
        x = _conv_bn_relu(x, p, f"decoder.blocks.{i}.conv1")
        x = _conv_bn_relu(x, p, f"decoder.blocks.{i}.conv2")
    return F.conv2d(x, p["segmentation_head.0.weight"],
                    p["segmentation_head.0.bias"], padding=1)
