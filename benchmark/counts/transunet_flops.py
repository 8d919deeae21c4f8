"""FLOPs of TransUNet R50-ViT-B/16 (Chen et al., arXiv:2102.04306;
``get_r50_b16_config`` of github.com/Beckschen/TransUNet) from its widths
and its fixed grid, and the least time of its attention.

2 FLOPs per multiply-add of every convolution, every linear layer and
the attention's two products (Q K^T, then the probabilities times V).
GroupNorm, LayerNorm, BatchNorm, the activations, the softmax, the
max-pool, the bilinear upsampling and the additions are memory work and
are not counted.  ``net`` is the configuration file's ``network``
(the keys of the port's ``TransUNetConfig``)."""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.counts import peaks


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def r50_macs(net: dict) -> float:
    """The stem and the three stages of bottleneck units at the grid:
    the 7x7/2 stem, the 3x3/2 max-pool without padding, each unit's 1x1,
    3x3 (the stage's stride on the first unit's) and 1x1 convolutions,
    and the 1x1 projections."""
    width = 64 * net["width_factor"]
    x = _out(net["img_size"], 7, 2, 3)
    macs = x * x * 49 * 3 * width
    x = _out(x, 3, 2, 0)
    cin = width
    for s, units in enumerate(net["resnet_units"]):
        cout, cmid = width * 4 * 2 ** s, width * 2 ** s
        for i in range(units):
            stride = 2 if (s > 0 and i == 0) else 1
            y = _out(x, 3, stride, 1)
            macs += x * x * cin * cmid + y * y * 9 * cmid * cmid \
                + y * y * cmid * cout
            if stride != 1 or cin != cout:
                macs += y * y * cin * cout
            x, cin = y, cout
    return float(macs)


def embedding_macs(net: dict) -> float:
    g = net["img_size"] // 16
    return float(g * g * 64 * net["width_factor"] * 16 * net["hidden_size"])


def attention_macs(net: dict) -> float:
    """Q K^T and the probabilities times V of every layer and head."""
    n = (net["img_size"] // 16) ** 2
    return float(net["num_layers"] * 2 * n * n * net["hidden_size"])


def encoder_macs(net: dict) -> float:
    """Each layer's query, key, value and output projections, its MLP,
    and the attention's products."""
    n = (net["img_size"] // 16) ** 2
    h, m = net["hidden_size"], net["mlp_dim"]
    return float(net["num_layers"] * (4 * n * h * h + 2 * n * h * m)) \
        + attention_macs(net)


def decoder_macs(net: dict) -> float:
    """The 3x3 convolution to ``head_channels`` at the token grid, each
    block's two 3x3 convolutions after the x2 upsampling (the first over
    the skip's channels too), and the 3x3 head."""
    x = net["img_size"] // 16
    macs = x * x * 9 * net["hidden_size"] * net["head_channels"]
    cin = net["head_channels"]
    for i, cout in enumerate(net["decoder_channels"]):
        x *= 2
        skip = net["skip_channels"][i] if i < net["n_skip"] else 0
        macs += x * x * 9 * (cin + skip) * cout + x * x * 9 * cout * cout
        cin = cout
    macs += x * x * 9 * cin * net["n_class"]
    return float(macs)


def transunet_forward_flops(net: dict) -> float:
    """One slice's forward at the grid."""
    return 2.0 * (r50_macs(net) + embedding_macs(net) + encoder_macs(net)
                  + decoder_macs(net))


def attention_bound(net: dict, elem_bytes: int = 4) -> Tuple[float, str]:
    """The least time of one slice's attention (every layer and head):
    the two products' FLOPs over the float32 peak, against Q, K, V read
    once and O written once over the memory rate.  Returns (seconds,
    'operations' | 'bytes')."""
    pk = peaks()
    n = (net["img_size"] // 16) ** 2
    t_ops = 2.0 * attention_macs(net) / pk["float32_flops"]
    t_bytes = net["num_layers"] * 4 * n * net["hidden_size"] * elem_bytes \
        / pk["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def parts(net: dict) -> Dict[str, float]:
    """Multiply-adds of one slice by part, for the record."""
    return {"r50": r50_macs(net), "embedding": embedding_macs(net),
            "encoder": encoder_macs(net), "attention": attention_macs(net),
            "decoder": decoder_macs(net)}
