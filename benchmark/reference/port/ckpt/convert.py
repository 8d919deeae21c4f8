"""Carry weights between the JAX package's layout and the port's modules,
both ways.

The JAX package keeps parameters as nested dicts named like TF's
``tf.layers`` (``conv2d_3``, ``batch_normalization_3``), with HWIO conv
kernels.  The port's modules hold OIHW kernels under structural names.
Conv kernels go from HWIO (DHWIO) to OIHW (OIDHW) and back; transposed-conv
kernels keep the bundles' correlation orientation, so the one transpose
serves them too.

Each model has one *layout*: a list of ``(port key, tree, path)`` with
``tree`` ``"params"`` or ``"state"`` and ``path`` the key path in the JAX
pytree.  The loaders (``*_from_jax``), the writers (``*_to_jax``) and the
optimizer-state mapping (:func:`adam_leaves`, :func:`load_adam_leaves`)
all read it, so there is one mapping per model.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.port.models.convlstm import BiConvLSTM, ConvLSTM
from benchmark.reference.port.models.fcn import FCN, FCNConfig
from benchmark.reference.port.models.unet import UNet, UNetConfig

Layout = List[Tuple[str, str, Tuple[str, ...]]]


def _oihw(kernel) -> torch.Tensor:
    """HWIO / DHWIO kernel -> OIHW / OIDHW float32 tensor."""
    k = np.asarray(kernel, np.float32)
    order = (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))
    return torch.from_numpy(np.ascontiguousarray(k.transpose(order)))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def to_port(value, path) -> torch.Tensor:
    """A JAX-layout leaf at ``path`` -> the port's tensor."""
    return _oihw(value) if path[-1] == "kernel" else _vec(value)


def _conv_bn(prefix: str, pair) -> Layout:
    cname, bname = pair
    return [(f"{prefix}.weight", "params", (cname, "kernel")),
            (f"{prefix}.gamma", "params", (bname, "gamma")),
            (f"{prefix}.beta", "params", (bname, "beta")),
            (f"{prefix}.moving_mean", "state", (bname, "moving_mean")),
            (f"{prefix}.moving_variance", "state",
             (bname, "moving_variance"))]


def fcn_layout(names, cfg: FCNConfig) -> Layout:
    """Layout of an :class:`FCN`."""
    out: Layout = []
    for l, pairs in enumerate(names["levels"]):
        for i, pair in enumerate(pairs):
            out += _conv_bn(f"levels.{l}.{i}", pair)
    for l in range(cfg.n_level):
        out += _conv_bn(f"same_dim.{l}", names["same_dim"][l])
    for i, pair in enumerate(names["fc"]):
        out += _conv_bn(f"fc.{i}", pair)
    out += [("out.weight", "params", (names["out"], "kernel")),
            ("out.bias", "params", (names["out"], "bias"))]
    return out


def unet_layout(names) -> Layout:
    """Layout of a :class:`UNet` (2D or temporal); the JAX params nest
    under ``names['scope']`` and each level's sub-scope."""
    scope = names["scope"]
    out: Layout = []
    for group in ("down", "up"):
        for l, (sub, pairs) in enumerate(names[group]):
            for i, pair in enumerate(pairs):
                out += [(k, tree, (scope, sub) + path) for k, tree, path in
                        _conv_bn(f"{group}.{l}.{i}", pair)]
    sub, cname = names["out"]
    out += [("out_weight", "params", (scope, sub, cname, "kernel")),
            ("out_bias", "params", (scope, sub, cname, "bias"))]
    return out


def convlstm_layout(bidirectional: bool) -> Layout:
    """Layout of the ``LSTM`` tree of a UNet-LSTM bundle."""
    if bidirectional:
        cells = [("forward_cell", ("LSTM", "forward", "conv_2d_lstm_cell")),
                 ("backward_cell",
                  ("LSTM", "backward", "conv_2d_lstm_cell"))]
        out_path = ("LSTM", "output", "conv2d")
    else:
        cells = [("cell", ("LSTM", "conv_2d_lstm_cell"))]
        out_path = ("LSTM", "conv2d")
    out: Layout = []
    for name, path in cells:
        out += [(f"{name}.weight", "params", path + ("kernel",)),
                (f"{name}.bias", "params", path + ("biases",))]
    return out + [("out_weight", "params", out_path + ("kernel",)),
                  ("out_bias", "params", out_path + ("bias",))]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def state_dict_from_jax(layout: Layout, params,
                        state) -> Dict[str, torch.Tensor]:
    trees = {"params": params, "state": state}
    return {key: to_port(_get(trees[tree], path), path)
            for key, tree, path in layout}


def fcn_state_dict_from_jax(params, state, names,
                            cfg: FCNConfig) -> Dict[str, torch.Tensor]:
    """JAX-package FCN (or ResNet-FCN) params/state (numpy or jax arrays)
    -> the port's ``state_dict``: conv HWIO -> OIHW, BN gamma/beta and
    moving statistics carried as they are."""
    return state_dict_from_jax(fcn_layout(names, cfg), params, state)


def fcn_from_jax(params, state, names, cfg: FCNConfig) -> FCN:
    """An eval-mode :class:`FCN` on the CPU holding the JAX weights."""
    model = FCN(cfg)
    model.load_state_dict(fcn_state_dict_from_jax(params, state, names, cfg))
    return model.eval()


def unet_state_dict_from_jax(params, state, names) -> Dict[str, torch.Tensor]:
    """JAX-package U-Net params/state (nested under ``names['scope']``,
    e.g. ``UNet/conv0/conv2d``) -> the port's :class:`UNet` ``state_dict``;
    2D and temporal alike."""
    return state_dict_from_jax(unet_layout(names), params, state)


def unet_from_jax(params, state, names, cfg: UNetConfig,
                  temporal: bool = False) -> UNet:
    """An eval-mode :class:`UNet` (3D convs if ``temporal``) on the CPU
    holding the JAX weights."""
    model = UNet(cfg, dims=3 if temporal else 2)
    model.load_state_dict(unet_state_dict_from_jax(params, state, names))
    return model.eval()


def convlstm_from_jax(params, bidirectional: bool = True):
    """The ``LSTM`` tree of a UNet-LSTM bundle (``LSTM/{forward,backward,
    output}`` or, unidirectional, ``LSTM/{conv_2d_lstm_cell,conv2d}``) ->
    an eval-mode :class:`BiConvLSTM` / :class:`ConvLSTM` on the CPU."""
    sd = state_dict_from_jax(convlstm_layout(bidirectional), params, {})
    w = sd["forward_cell.weight" if bidirectional else "cell.weight"]
    n_hidden = w.shape[0] // 4
    cls = BiConvLSTM if bidirectional else ConvLSTM
    model = cls(w.shape[1] - n_hidden, n_hidden, sd["out_weight"].shape[0])
    model.load_state_dict(sd)
    return model.eval()

