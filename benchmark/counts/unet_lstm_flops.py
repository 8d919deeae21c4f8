"""FLOPs of the aortic UNet-LSTM (Bai et al. 2018, ``common/network_ao.py``)
from its widths and the frame shape: 2 per multiply-add of every
convolution; BatchNorm, the gates' nonlinearities and the softmax are
memory work and are not counted."""

from __future__ import annotations


def unet_forward_flops(cfg: dict, X: int, Y: int) -> float:
    """One frame's U-Net forward at X x Y: the encoder's 3x3 convolutions
    (stride 2 at each level's first block from level 1), each decoder
    level's 3x3 transposed convolution counted by its input pixels (the
    products that are not with stuffed zeros), its 3x3 convolutions over
    [skip, up], and the 1x1 output convolution."""
    f, nb = cfg["n_filter"], cfg["n_block"]
    sizes, x, y = [], X, Y
    macs, cin = 0.0, cfg.get("in_ch", 1)
    for l in range(cfg["n_level"]):
        if l > 0:
            x, y = -(-x // 2), -(-y // 2)
        sizes.append(x * y)
        for _ in range(nb[l]):
            macs += x * y * 9 * cin * f[l]
            cin = f[l]
    for l in range(cfg["n_level"] - 2, -1, -1):
        macs += sizes[l + 1] * 9 * f[l + 1] * f[l]
        cin = 2 * f[l]
        for _ in range(nb[l]):
            macs += sizes[l] * 9 * cin * f[l]
            cin = f[l]
    macs += X * Y * f[0] * cfg["n_class"]
    return 2.0 * macs


def convlstm_forward_flops(n_frames: int, X: int, Y: int, c_in: int,
                           hidden: int, n_class: int,
                           directions: int = 2) -> float:
    """A (bi)directional ConvLSTM over ``n_frames`` frames: each step's
    3x3 gate convolution over [x, h] (4 gates), then the 1x1 output
    convolution over the directions' hidden states."""
    gates = 2.0 * X * Y * (c_in + hidden) * 4 * hidden * 9
    out = 2.0 * X * Y * directions * hidden * n_class
    return n_frames * (directions * gates + out)


def unet_lstm_forward_flops(cfg: dict, n_frames: int, X: int, Y: int
                            ) -> float:
    """A cine of ``n_frames`` frames through the U-Net, then the ConvLSTM
    over the U-Net's last features (``n_filter[0]`` channels)."""
    return (n_frames * unet_forward_flops(cfg["unet"], X, Y)
            + convlstm_forward_flops(n_frames, X, Y, cfg["unet"]["n_filter"][0],
                                     cfg["lstm_hidden"],
                                     cfg["unet"]["n_class"],
                                     2 if cfg["bidirectional"] else 1))


def phase2_train_flops(cfg: dict, n_frames: int, X: int, Y: int) -> float:
    """One phase-2 training step over ``n_frames`` frames: the frozen
    U-Net's forward, the ConvLSTM's forward and its backward (twice the
    forward's FLOPs)."""
    return (n_frames * unet_forward_flops(cfg["unet"], X, Y)
            + 3.0 * convlstm_forward_flops(
                n_frames, X, Y, cfg["unet"]["n_filter"][0],
                cfg["lstm_hidden"], cfg["unet"]["n_class"],
                2 if cfg["bidirectional"] else 1))
