"""FLOPs of the FCN (Bai et al. 2018, ``common/network.py::build_FCN``)
from its widths and the input shape: 2 per multiply-add of every
convolution.  BatchNorm, ReLU, the upsampling and the softmax are memory
work and are not counted."""

from __future__ import annotations


def fcn_forward_flops(cfg: dict, X: int, Y: int) -> float:
    """One slice's forward at X x Y: the encoder's 3x3 convolutions (stride
    2 at each level's first block from level 1), each level's 1x1
    same-dim projection, then fc1 over the levels' concatenation, fc2 and
    the output convolution at full resolution (the published head)."""
    macs = 0.0
    cin, x, y = cfg.get("in_ch", 1), X, Y
    for l in range(cfg["n_level"]):
        if l > 0:
            x, y = -(-x // 2), -(-y // 2)
        for _ in range(cfg["n_block"][l]):
            macs += x * y * 9 * cin * cfg["n_filter"][l]
            cin = cfg["n_filter"][l]
        macs += x * y * cfg["n_filter"][l] * cfg["same_dim"]
    full = X * Y
    macs += full * cfg["same_dim"] * cfg["n_level"] * cfg["fc"]
    macs += full * cfg["fc"] * cfg["fc"]
    macs += full * cfg["fc"] * cfg["n_class"]
    return 2.0 * macs


def fcn_train_flops(cfg: dict, n: int, X: int, Y: int) -> float:
    """One training step of ``n`` slices: the forward and a backward of
    twice its FLOPs (gradients of inputs and of weights)."""
    return 3.0 * n * fcn_forward_flops(cfg, X, Y)
