"""Reader and writer of the native model bundle (.npz + JSON ``__meta__``).

The bundle format belongs to the JAX package (``ckpt/store.py``): a JSON
header (``format ukbb_cardiac_tpu.model_bundle.v1``) with the model kind,
config and layer-name structure, and every weight tensor as an npz entry
under ``params/`` or ``state/``, in the JAX layouts (HWIO kernels).  A
trainer's bundle also holds its optimizer state as ``opt/{i}`` leaves in
optax's flattening order with their count ``n_opt_leaves``.  Nothing in
it depends on a framework, so the port reads and writes it with numpy;
the JAX package reads what the port writes.  A ``transunet`` bundle (a
kind of the port alone) keeps PyTorch's layout (``ckpt/convert.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

import numpy as np

from ukbb_cardiac_tpu_torch.models.fcn import FCNConfig, ResNetConfig
from ukbb_cardiac_tpu_torch.models.transunet import TransUNetConfig
from ukbb_cardiac_tpu_torch.models.unet import UNetConfig

_META_KEY = "__meta__"
FORMAT = "ukbb_cardiac_tpu.model_bundle.v1"

_CFG_TYPES = {"fcn": FCNConfig, "resnet": ResNetConfig, "unet": UNetConfig,
              "temporal_unet": UNetConfig, "unet_lstm": UNetConfig,
              "transunet": TransUNetConfig}


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def save_model(path: str, kind: str, cfg, names, params, state,
               extra_meta: dict | None = None, opt_leaves=None) -> None:
    """Write a model bundle as ``store.save_model`` of the JAX package
    does.  ``params`` / ``state`` are JAX-layout nested dicts of numpy
    arrays (``ckpt.convert.fcn_to_jax``); ``opt_leaves`` the optimizer
    state as optax leaves (``ckpt.convert.adam_leaves``)."""
    meta = {
        "format": FORMAT,
        "kind": kind,
        "cfg": (dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg)
                else dict(cfg)),
        "names": names,
        "extra": extra_meta or {},
    }
    arrays = {}
    for name, tree in (("params", params), ("state", state)):
        arrays.update(_flatten(tree, name + "/"))
    if opt_leaves is not None:
        meta["n_opt_leaves"] = len(opt_leaves)
        for i, leaf in enumerate(opt_leaves):
            arrays[f"opt/{i}"] = np.asarray(leaf)
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                      dtype=np.uint8)
    np.savez(path, **arrays)


def load_opt_state(path: str):
    """The optimizer leaves a bundle holds (optax's flattening order), or
    None if it holds none; ``ckpt.convert.load_adam_leaves`` maps them
    into a ``torch.optim.Adam``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8"))
        n = meta.get("n_opt_leaves")
        if n is None:
            return None
        return [z[f"opt/{i}"] for i in range(n)]


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _tuplize_names(obj):
    """JSON round-trips tuples as lists; restore (cname, bname) leaf pairs
    to tuples so loaded names compare like freshly built ones."""
    if isinstance(obj, list):
        if len(obj) == 2 and all(isinstance(x, str) for x in obj):
            return tuple(obj)
        return [_tuplize_names(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _tuplize_names(v) for k, v in obj.items()}
    return obj


def load_model(path: str) -> Tuple[str, Any, Any, Dict, Dict]:
    """Read a model bundle -> (kind, cfg, names, params, state)."""
    return load_model_with_extra(path)[:5]


def load_model_with_extra(path: str) -> Tuple[str, Any, Any, Dict, Dict,
                                              Dict]:
    """Read a model bundle -> (kind, cfg, names, params, state, extra).

    ``params``/``state`` are nested dicts of numpy arrays in the JAX
    package's layouts (HWIO kernels).  ``cfg`` is an :class:`FCNConfig`
    for kind ``fcn``, a :class:`ResNetConfig` for ``resnet``, a
    :class:`UNetConfig` for ``unet``,
    ``temporal_unet`` and ``unet_lstm``, a :class:`TransUNetConfig` for
    ``transunet``, and the raw config dict for kinds
    not ported yet.  ``extra`` is the bundle's free-form metadata (e.g.
    ``bidirectional``).
    """
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8"))
        flat_p, flat_s = {}, {}
        for key in z.files:
            if key.startswith("params/"):
                flat_p[key[len("params/"):]] = z[key]
            elif key.startswith("state/"):
                flat_s[key[len("state/"):]] = z[key]
    kind = meta["kind"]
    cfg_cls = _CFG_TYPES.get(kind)
    cfg_dict = meta["cfg"]
    if cfg_cls is not None:
        fields = {f.name for f in dataclasses.fields(cfg_cls)}
        cfg = cfg_cls(**{k: (tuple(v) if isinstance(v, list) else v)
                         for k, v in cfg_dict.items() if k in fields})
    else:
        cfg = cfg_dict
    names = _tuplize_names(meta["names"])
    return (kind, cfg, names, _unflatten(flat_p), _unflatten(flat_s),
            meta.get("extra", {}))
