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

TransUNet (``transunet`` bundles) has no JAX counterpart: its tensors
keep PyTorch's layout under the published module's state-dict names,
split at the dots into the ``params`` (parameters) and ``state``
(buffers) trees (:func:`transunet_to_bundle`, :func:`transunet_from_bundle`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ukbb_cardiac_tpu_torch.models.convlstm import BiConvLSTM, ConvLSTM
from ukbb_cardiac_tpu_torch.models.fcn import (FCN, FCNConfig, ResNetConfig,
                                               ResNetFCN)
from ukbb_cardiac_tpu_torch.models.transunet import (TransUNet,
                                                     TransUNetConfig)
from ukbb_cardiac_tpu_torch.models.unet import UNet, UNetConfig

Layout = List[Tuple[str, str, Tuple[str, ...]]]


def _oihw(kernel) -> torch.Tensor:
    """HWIO / DHWIO kernel -> OIHW / OIDHW float32 tensor."""
    k = np.asarray(kernel, np.float32)
    order = (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))
    return torch.from_numpy(np.ascontiguousarray(k.transpose(order)))


def _hwio(weight) -> np.ndarray:
    """OIHW / OIDHW tensor -> HWIO / DHWIO float32 numpy array."""
    w = weight.detach().cpu().float().numpy()
    order = tuple(range(2, w.ndim)) + (1, 0)
    return np.ascontiguousarray(w.transpose(order))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def to_port(value, path) -> torch.Tensor:
    """A JAX-layout leaf at ``path`` -> the port's tensor."""
    return _oihw(value) if path[-1] == "kernel" else _vec(value)


def to_jax(tensor: torch.Tensor, path) -> np.ndarray:
    """The port's tensor -> the JAX-layout leaf at ``path``."""
    if path[-1] == "kernel":
        return _hwio(tensor)
    return tensor.detach().cpu().float().numpy().copy()


class Namer:
    """tf.layers' graph-order unique naming: conv2d, conv2d_1, ...
    (``layers.Namer``)."""

    def __init__(self):
        self.counts = {}

    def __call__(self, base: str) -> str:
        n = self.counts.get(base, 0)
        self.counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"


def fcn_names(cfg: FCNConfig) -> dict:
    """The layer-name structure ``fcn.init_fcn`` / ``init_resnet`` build
    (a :class:`ResNetConfig` gives the ResNet's), in their creation
    order: encoder, same-dim projections, fc, the output conv."""
    namer = Namer()

    def pair():
        return (namer("conv2d"), namer("batch_normalization"))

    resnet = isinstance(cfg, ResNetConfig)
    names = {"levels": []}
    if resnet:
        names["res_levels"] = []
    for l in range(2 if resnet else cfg.n_level):
        names["levels"].append([pair() for _ in range(cfg.n_block[l])])
    if resnet:
        in_ch = cfg.n_filter[1]
        for l in range(2, cfg.n_level):
            units = []
            for i in range(cfg.n_block[l]):
                unit = {"convs": [], "bns": [], "shortcut": None}
                for _ in range(3 if cfg.use_bottleneck else 2):
                    unit["bns"].append(namer("batch_normalization"))
                    unit["convs"].append(namer("conv2d"))
                stride = 2 if i == 0 else 1
                if in_ch != cfg.n_filter[l] or stride != 1:
                    unit["shortcut"] = namer("conv2d")
                unit["strides"] = stride
                unit["bottleneck"] = cfg.use_bottleneck
                units.append(unit)
                in_ch = cfg.n_filter[l]
            names["res_levels"].append(units)
    names["same_dim"] = [pair() for _ in range(cfg.n_level)]
    names["fc"] = [pair() for _ in range(2)]
    names["out"] = namer("conv2d")
    return names


def unet_names(cfg: UNetConfig, temporal: bool = False,
               scope: str = "UNet") -> dict:
    """The layer-name structure ``unet.init_unet`` builds: per level a
    sub-scope (``conv{l}``, ``conv{l}_up``) with its own tf.layers
    naming, the output conv under ``conv_out``."""
    base = "conv3d" if temporal else "conv2d"
    names = {"down": [], "up": [], "scope": scope}
    for l in range(cfg.n_level):
        namer = Namer()
        names["down"].append((f"conv{l}", [
            (namer(base), namer("batch_normalization"))
            for _ in range(cfg.n_block[l])]))
    for l in range(cfg.n_level - 2, -1, -1):
        namer = Namer()
        pairs = [(namer(base + "_transpose"), namer("batch_normalization"))]
        pairs += [(namer(base), namer("batch_normalization"))
                  for _ in range(cfg.n_block[l])]
        names["up"].append((f"conv{l}_up", pairs))
    names["out"] = ("conv_out", Namer()(base))
    return names


def _conv_bn(prefix: str, pair) -> Layout:
    cname, bname = pair
    return [(f"{prefix}.weight", "params", (cname, "kernel")),
            (f"{prefix}.gamma", "params", (bname, "gamma")),
            (f"{prefix}.beta", "params", (bname, "beta")),
            (f"{prefix}.moving_mean", "state", (bname, "moving_mean")),
            (f"{prefix}.moving_variance", "state",
             (bname, "moving_variance"))]


def fcn_layout(names, cfg: FCNConfig) -> Layout:
    """Layout of an :class:`FCN`, or of a :class:`ResNetFCN` when
    ``names`` has ``res_levels``."""
    out: Layout = []
    for l, pairs in enumerate(names["levels"]):
        for i, pair in enumerate(pairs):
            out += _conv_bn(f"levels.{l}.{i}", pair)
    for r, units in enumerate(names.get("res_levels", [])):
        l = r + len(names["levels"])
        for i, unit in enumerate(units):
            prefix = f"levels.{l}.{i}"
            for j, (cname, bname) in enumerate(zip(unit["convs"],
                                                   unit["bns"])):
                out += [(f"{prefix}.convs.{j}", "params", (cname, "kernel")),
                        (f"{prefix}.bns.{j}.gamma", "params",
                         (bname, "gamma")),
                        (f"{prefix}.bns.{j}.beta", "params",
                         (bname, "beta")),
                        (f"{prefix}.bns.{j}.moving_mean", "state",
                         (bname, "moving_mean")),
                        (f"{prefix}.bns.{j}.moving_variance", "state",
                         (bname, "moving_variance"))]
            if unit["shortcut"] is not None:
                out.append((f"{prefix}.shortcut", "params",
                            (unit["shortcut"], "kernel")))
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


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def state_dict_from_jax(layout: Layout, params,
                        state) -> Dict[str, torch.Tensor]:
    trees = {"params": params, "state": state}
    return {key: to_port(_get(trees[tree], path), path)
            for key, tree, path in layout}


def jax_from_state_dict(layout: Layout, sd) -> Tuple[dict, dict]:
    """The port's ``state_dict`` -> JAX-layout (params, state) nested
    dicts of float32 numpy arrays."""
    trees = {"params": {}, "state": {}}
    for key, tree, path in layout:
        _set(trees[tree], path, to_jax(sd[key], path))
    return trees["params"], trees["state"]


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


def resnet_from_jax(params, state, names, cfg: ResNetConfig) -> ResNetFCN:
    """An eval-mode :class:`ResNetFCN` on the CPU holding the JAX
    weights."""
    model = ResNetFCN(cfg)
    model.load_state_dict(fcn_state_dict_from_jax(params, state, names, cfg))
    return model.eval()


def fcn_to_jax(net: FCN, names) -> Tuple[dict, dict]:
    """An :class:`FCN` / :class:`ResNetFCN` -> JAX-layout (params, state)
    numpy pytrees under ``names`` (e.g. :func:`fcn_names`)."""
    return jax_from_state_dict(fcn_layout(names, net.cfg), net.state_dict())


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


def unet_to_jax(net: UNet, names) -> Tuple[dict, dict]:
    """A :class:`UNet` -> JAX-layout (params, state) numpy pytrees."""
    return jax_from_state_dict(unet_layout(names), net.state_dict())


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


def convlstm_to_jax(net) -> dict:
    """A :class:`BiConvLSTM` / :class:`ConvLSTM` -> its JAX-layout
    ``{"LSTM": ...}`` params tree."""
    layout = convlstm_layout(isinstance(net, BiConvLSTM))
    return jax_from_state_dict(layout, net.state_dict())[0]


def transunet_to_bundle(net: TransUNet) -> Tuple[dict, dict, dict]:
    """A :class:`TransUNet` -> (names, params, state) for
    ``store.save_model(path, "transunet", net.cfg, names, params,
    state)``: ``names`` lists the parameters' and the buffers' keys, the
    trees hold them as numpy arrays in PyTorch's layout."""
    trees = {"params": {}, "state": {}}
    names = {"params": [], "state": []}
    sd = net.state_dict()
    params = {k for k, _ in net.named_parameters()}
    for key, t in sd.items():
        tree = "params" if key in params else "state"
        names[tree].append(key)
        _set(trees[tree], tuple(key.split(".")),
             t.detach().cpu().numpy().copy())
    return names, trees["params"], trees["state"]


def transunet_from_bundle(params, state, names,
                          cfg: TransUNetConfig) -> TransUNet:
    """An eval-mode :class:`TransUNet` on the CPU holding a bundle's
    tensors; every tensor the module holds must be in the bundle, and
    nothing else."""
    trees = {"params": params, "state": state}
    sd = {key: torch.from_numpy(np.asarray(
              _get(trees[tree], tuple(key.split(".")))))
          for tree in ("params", "state") for key in names[tree]}
    model = TransUNet(cfg)
    model.load_state_dict(sd)
    return model.eval()


def _adam_order(layout: Layout) -> Layout:
    """The params entries of ``layout`` in optax's leaf order: the params
    pytree flattened with sorted keys at every level."""
    return sorted((e for e in layout if e[1] == "params"),
                  key=lambda e: e[2])


def adam_leaves(optimizer: torch.optim.Adam, net: torch.nn.Module,
                layout: Layout) -> List[np.ndarray]:
    """An Adam's state (the port's ``train.steps.Adam`` or a
    ``torch.optim.Adam``) -> the leaves of the ``optax.adam`` state
    (``chain(scale_by_adam, scale_by_learning_rate)``) in its flattening
    order: ``count`` (int32), ``mu``'s leaves, then ``nu``'s, each in the
    params pytree's sorted-key order, kernels HWIO.  The step count is
    read from the device here, at checkpoint time only."""
    params = dict(net.named_parameters())
    order = _adam_order(layout)
    mu, nu, step = [], [], 0
    for key, _, path in order:
        st = optimizer.state.get(params[key], {})
        if st:
            step = int(st["step"])
            mu.append(to_jax(st["exp_avg"], path))
            nu.append(to_jax(st["exp_avg_sq"], path))
        else:
            zero = to_jax(torch.zeros_like(params[key]), path)
            mu.append(zero)
            nu.append(zero.copy())
    return [np.asarray(step, np.int32)] + mu + nu


def load_adam_leaves(optimizer: torch.optim.Adam, net: torch.nn.Module,
                     layout: Layout, leaves) -> None:
    """The inverse of :func:`adam_leaves`: set ``optimizer``'s per-
    parameter ``step``, ``exp_avg`` and ``exp_avg_sq`` from optax leaves
    (each on its parameter's device, the moments in its memory format),
    before the trainer's programs are built: they read these tensors by
    address."""
    params = dict(net.named_parameters())
    order = _adam_order(layout)
    if len(leaves) != 1 + 2 * len(order):
        raise ValueError(f"optimizer structure mismatch: {len(leaves)} "
                         f"leaves for {len(order)} parameters (expected "
                         f"{1 + 2 * len(order)})")
    count = float(np.asarray(leaves[0]))
    n = len(order)
    for i, (key, _, path) in enumerate(order):
        p = params[key]
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32,
                                 device=p.device),
            # in the parameter's own memory format (channels-last too)
            "exp_avg": torch.empty_like(p).copy_(to_port(leaves[1 + i],
                                                         path)),
            "exp_avg_sq": torch.empty_like(p).copy_(
                to_port(leaves[1 + n + i], path))}
