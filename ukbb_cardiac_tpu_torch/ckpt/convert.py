"""Carry the JAX package's FCN, U-Net and ConvLSTM weights into the port's
modules.

The JAX package keeps parameters as nested dicts named like TF's
``tf.layers`` (``conv2d_3``, ``batch_normalization_3``), with HWIO conv
kernels.  The port's modules hold OIHW kernels under structural names.
Conv kernels go from HWIO (DHWIO) to OIHW (OIDHW); transposed-conv
kernels keep the bundles' correlation orientation.  The bundle loaders and
the parity tests both go through these functions, so there is one mapping.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ukbb_cardiac_tpu_torch.models.convlstm import BiConvLSTM, ConvLSTM
from ukbb_cardiac_tpu_torch.models.fcn import FCN, FCNConfig
from ukbb_cardiac_tpu_torch.models.unet import UNet, UNetConfig


def _oihw(kernel) -> torch.Tensor:
    """HWIO / DHWIO kernel -> OIHW / OIDHW float32 tensor."""
    k = np.asarray(kernel, np.float32)
    order = (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))
    return torch.from_numpy(np.ascontiguousarray(k.transpose(order)))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def _conv_bn(prefix: str, pair, params, state) -> Dict[str, torch.Tensor]:
    cname, bname = pair
    return {
        f"{prefix}.weight": _oihw(params[cname]["kernel"]),
        f"{prefix}.gamma": _vec(params[bname]["gamma"]),
        f"{prefix}.beta": _vec(params[bname]["beta"]),
        f"{prefix}.moving_mean": _vec(state[bname]["moving_mean"]),
        f"{prefix}.moving_variance": _vec(state[bname]["moving_variance"]),
    }


def fcn_state_dict_from_jax(params, state, names,
                            cfg: FCNConfig) -> Dict[str, torch.Tensor]:
    """JAX-package FCN params/state (numpy or jax arrays) -> the port's
    :class:`FCN` ``state_dict``: conv HWIO -> OIHW, BN gamma/beta and
    moving statistics carried as they are."""
    sd: Dict[str, torch.Tensor] = {}
    for l in range(cfg.n_level):
        for i, pair in enumerate(names["levels"][l]):
            sd.update(_conv_bn(f"levels.{l}.{i}", pair, params, state))
        sd.update(_conv_bn(f"same_dim.{l}", names["same_dim"][l],
                           params, state))
    for i, pair in enumerate(names["fc"]):
        sd.update(_conv_bn(f"fc.{i}", pair, params, state))
    out = params[names["out"]]
    sd["out.weight"] = _oihw(out["kernel"])
    sd["out.bias"] = _vec(out["bias"])
    return sd


def fcn_from_jax(params, state, names, cfg: FCNConfig) -> FCN:
    """An eval-mode :class:`FCN` on the CPU holding the JAX weights."""
    model = FCN(cfg)
    model.load_state_dict(fcn_state_dict_from_jax(params, state, names, cfg))
    return model.eval()


def unet_state_dict_from_jax(params, state, names) -> Dict[str, torch.Tensor]:
    """JAX-package U-Net params/state (nested under ``names['scope']``,
    e.g. ``UNet/conv0/conv2d``) -> the port's :class:`UNet` ``state_dict``;
    2D and temporal alike."""
    scope = names["scope"]
    p, s = params[scope], state[scope]
    sd: Dict[str, torch.Tensor] = {}
    for l, (sub, pairs) in enumerate(names["down"]):
        for i, pair in enumerate(pairs):
            sd.update(_conv_bn(f"down.{l}.{i}", pair, p[sub], s[sub]))
    for u, (sub, pairs) in enumerate(names["up"]):
        for i, pair in enumerate(pairs):
            sd.update(_conv_bn(f"up.{u}.{i}", pair, p[sub], s[sub]))
    sub, cname = names["out"]
    sd["out_weight"] = _oihw(p[sub][cname]["kernel"])
    sd["out_bias"] = _vec(p[sub][cname]["bias"])
    return sd


def unet_from_jax(params, state, names, cfg: UNetConfig,
                  temporal: bool = False) -> UNet:
    """An eval-mode :class:`UNet` (3D convs if ``temporal``) on the CPU
    holding the JAX weights."""
    model = UNet(cfg, dims=3 if temporal else 2)
    model.load_state_dict(unet_state_dict_from_jax(params, state, names))
    return model.eval()


def _cell(tree) -> Dict[str, torch.Tensor]:
    return {"weight": _oihw(tree["kernel"]), "bias": _vec(tree["biases"])}


def convlstm_from_jax(params, bidirectional: bool = True):
    """The ``LSTM`` tree of a UNet-LSTM bundle (``LSTM/{forward,backward,
    output}`` or, unidirectional, ``LSTM/{conv_2d_lstm_cell,conv2d}``) ->
    an eval-mode :class:`BiConvLSTM` / :class:`ConvLSTM` on the CPU."""
    p = params["LSTM"]
    if bidirectional:
        cells = {"forward_cell": _cell(p["forward"]["conv_2d_lstm_cell"]),
                 "backward_cell": _cell(p["backward"]["conv_2d_lstm_cell"])}
        out = p["output"]["conv2d"]
        cls = BiConvLSTM
    else:
        cells = {"cell": _cell(p["conv_2d_lstm_cell"])}
        out = p["conv2d"]
        cls = ConvLSTM
    w = cells[next(iter(cells))]["weight"]
    n_hidden = w.shape[0] // 4
    model = cls(w.shape[1] - n_hidden, n_hidden, np.shape(out["kernel"])[-1])
    sd = {f"{name}.{k}": v for name, cell in cells.items()
          for k, v in cell.items()}
    sd["out_weight"] = _oihw(out["kernel"])
    sd["out_bias"] = _vec(out["bias"])
    model.load_state_dict(sd)
    return model.eval()
