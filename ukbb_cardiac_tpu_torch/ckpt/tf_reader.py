"""TF-1.x checkpoint → model bundle converter.

Counterpart of ``ukbb_cardiac_tpu/ckpt/tf_reader.py``.  The reference
ships five trained TF checkpoints (``FCN_sa``, ``FCN_la_2ch``,
``FCN_la_4ch``, ``FCN_la_4ch_seg4``, ``UNet-LSTM_ao``,
``demo_pipeline.py:50-54``).  This module reads a checkpoint's variable
values with TensorFlow's checkpoint reader (no graph import; TensorFlow
is needed on the converting host only, and imported only here, at call
time), infers the architecture from the variable shapes, and writes the
same npz bundle as the JAX package's converter: the same keys, shapes,
values and ``__meta__``.

The JAX package builds its name tree by initialising its models; the
port builds the same tree from its own name and layout functions
(``ckpt/convert.py``: :func:`fcn_names` / :func:`fcn_layout`,
:func:`unet_names` / :func:`unet_layout`, :func:`convlstm_layout`),
whose paths replicate ``tf.layers`` auto-naming.

Kernel layouts: conv kernels (HWIO) are copied as they are; TF's
``conv2d_transpose`` kernels (H, W, out, in), applied flipped, are
flipped on both spatial axes and channel-swapped once here into the
bundle's correlation HWIO (``layers.conv2d_transpose``); ConvLSTM cell
kernels and biases keep their layout (gate order i, j, f, o; forget
bias 1.0 at run time).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np

from ukbb_cardiac_tpu_torch.ckpt import convert, store
from ukbb_cardiac_tpu_torch.models.fcn import FCNConfig
from ukbb_cardiac_tpu_torch.models.unet import UNetConfig


def load_tf_variables(prefix: str) -> Dict[str, np.ndarray]:
    """Read all model variables of a TF checkpoint (Adam slots and
    power accumulators left out); needs tensorflow on the host."""
    try:
        from tensorflow.python.training import py_checkpoint_reader
        reader = py_checkpoint_reader.NewCheckpointReader(prefix)
    except ImportError as e:
        raise ImportError(
            "Converting TF checkpoints requires tensorflow on the host; "
            "deploy-time inference does not.") from e
    names = reader.get_variable_to_shape_map().keys()
    return {name: np.asarray(reader.get_tensor(name)) for name in names
            if not name.startswith("beta1_power")
            and not name.startswith("beta2_power")
            and "/Adam" not in name}


def _flip_transpose_kernel(k: np.ndarray) -> np.ndarray:
    """TF conv2d_transpose (H, W, out, in) → the bundle's correlation
    HWIO."""
    return np.ascontiguousarray(k[::-1, ::-1].transpose(0, 1, 3, 2))


def _fill(layout, tf_vars: Dict[str, np.ndarray]):
    """(params, state) nested dicts of the TF tensors at ``layout``'s
    paths; transposed-conv kernels into correlation HWIO."""
    trees = {"params": {}, "state": {}}
    for _, tree, path in layout:
        name = "/".join(path)
        if name not in tf_vars:
            raise KeyError(f"checkpoint missing variable {name}")
        t = tf_vars[name]
        if (path[-1] == "kernel" and len(path) >= 2
                and "conv2d_transpose" in path[-2] and t.ndim == 4):
            t = _flip_transpose_kernel(t)
        convert._set(trees[tree], path, np.asarray(t))
    return trees["params"], trees["state"]


def _infer_fcn_config(tf_vars: Dict[str, np.ndarray]) -> FCNConfig:
    """Reconstruct the FCNConfig from tf.layers-named variable shapes."""
    conv_names = sorted(
        (n for n in tf_vars if re.fullmatch(r"conv2d(_\d+)?/kernel", n)),
        key=lambda n: int((re.search(r"_(\d+)/", n) or [0, 0])[1] or 0))
    kshapes = [tf_vars[n].shape for n in conv_names]
    # the encoder: the leading 3x3 convs, grouped by output channels
    n_block, n_filter = [], []
    i = 0
    while i < len(kshapes) and kshapes[i][0] == 3:
        ch = kshapes[i][3]
        cnt = 0
        while i < len(kshapes) and kshapes[i][0] == 3 and kshapes[i][3] == ch:
            cnt += 1
            i += 1
        n_filter.append(int(ch))
        n_block.append(cnt)
    n_level = len(n_filter)
    same_dim = int(kshapes[i][3])       # the first 1x1 projection
    fc = int(kshapes[i + n_level][3])   # the first fc conv after them
    n_class = int(kshapes[-1][3])
    return FCNConfig(n_class=n_class, n_level=n_level,
                     n_filter=tuple(n_filter), n_block=tuple(n_block),
                     same_dim=same_dim, fc=fc)


def _infer_unet_config(tf_vars: Dict[str, np.ndarray]) -> UNetConfig:
    levels = sorted({int(m.group(1)) for n in tf_vars
                     if (m := re.match(r"UNet/conv(\d+)/", n))})
    n_level = max(levels) + 1
    n_filter, n_block = [], []
    for l in range(n_level):
        convs = [n for n in tf_vars
                 if re.fullmatch(rf"UNet/conv{l}/conv2d(_\d+)?/kernel", n)]
        n_block.append(len(convs))
        n_filter.append(int(tf_vars[sorted(convs)[0]].shape[3]))
    out_bias = tf_vars.get("UNet/conv_out/conv2d/bias")
    if out_bias is None:
        out_bias = tf_vars["LSTM/output/conv2d/bias"]
    return UNetConfig(n_class=int(out_bias.shape[0]), n_level=n_level,
                      n_filter=tuple(n_filter), n_block=tuple(n_block))


def convert_tf_checkpoint(prefix: str, out_path: Optional[str] = None) -> str:
    """Convert a reference TF checkpoint into a model bundle; returns the
    bundle's path (default: the prefix without ``.ckpt``, plus ``.npz``)."""
    tf_vars = load_tf_variables(prefix)
    out_path = out_path or prefix.replace(".ckpt", "") + ".npz"
    extra = {"source_checkpoint": prefix}

    if not any(n.startswith("UNet/") for n in tf_vars):
        cfg = _infer_fcn_config(tf_vars)
        names = convert.fcn_names(cfg)
        params, state = _fill(convert.fcn_layout(names, cfg), tf_vars)
        store.save_model(out_path, "fcn", cfg, names, params, state, extra)
        return out_path

    cfg = _infer_unet_config(tf_vars)
    names = convert.unet_names(cfg)
    layout = convert.unet_layout(names)
    has_lstm = any(n.startswith("LSTM/") for n in tf_vars)
    missing_out = []
    if has_lstm:
        bidir = any(n.startswith("LSTM/forward/") for n in tf_vars)
        layout = layout + convert.convlstm_layout(bidir)
        extra["bidirectional"] = bidir
        # a UNet-LSTM checkpoint may lack the stand-alone U-Net's output
        # conv, which the LSTM path does not run: the bundle keeps its
        # place with zeros (the JAX converter keeps its random init there)
        sub, cname = names["out"]
        if f"UNet/{sub}/{cname}/kernel" not in tf_vars:
            missing_out = [e for e in layout if e[2][:3] == ("UNet", sub,
                                                             cname)]
            layout = [e for e in layout if e not in missing_out]
    params, state = _fill(layout, tf_vars)
    if missing_out:
        n_in = cfg.n_filter[0]
        zeros = {"kernel": np.zeros((1, 1, n_in, cfg.n_class), np.float32),
                 "bias": np.zeros((cfg.n_class,), np.float32)}
        for _, _, path in missing_out:
            convert._set(params, path, zeros[path[-1]])
    store.save_model(out_path, "unet_lstm" if has_lstm else "unet", cfg,
                     names, params, state, extra)
    return out_path
