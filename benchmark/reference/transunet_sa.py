"""The plain reference of the ``transunet_sa`` configuration's SA deploy.

For one subject's raw cine it works out again, from the file and the
bundle alone, what ``infer/deploy.py::deploy_subject_sequence`` writes as
``seg_sa``: the percentile rescale, a centred zero pad to the fixed grid,
TransUNet R50-ViT-B/16's plain float32 forward in blocks of slices,
argmax, crop; with ``want_prob`` also the softmax probabilities.

The forward is the published one (Chen et al., arXiv:2102.04306;
``networks/vit_seg_modeling.py`` and ``vit_seg_modeling_resnet_skip.py``
of github.com/Beckschen/TransUNet) in plain ``torch`` operations over a
dict of tensors named as the published state dict: every convolution's
weight standardised in every forward, ``F.group_norm``,
``F.layer_norm``, ``softmax(Q K^T / 8) V`` computed in full,
``F.interpolate`` (bilinear, ``align_corners=True``), eval-mode
BatchNorm.  TF32 is off.  It imports nothing of the program (the suite's
copy is ``tests/transunet_plain.py``).

The bundle is written here too (:func:`write_bundle`): the weights drawn
from the run's seed by the recipe the configuration names
(``configs/transunet_sa.init.json``), in the port's bundle format.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness import phantoms
from benchmark.reference.fcn_sa import set_precision
from benchmark.reference.port.ckpt.store import load_model
from benchmark.reference.port.ops.crop import pad_to_size
from benchmark.reference.port.ops.intensity import rescale_intensity_torch

R50 = "transformer.embeddings.hybrid_model."
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HEAD_BIAS = "segmentation_head.0.bias"
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
FORMAT = "ukbb_cardiac_tpu.model_bundle.v1"

_WEIGHTS: Dict[tuple, Dict[str, torch.Tensor]] = {}


def _units(net):
    """(stage, unit, cin, cout, cmid, stride) of every bottleneck unit."""
    width = 64 * net["width_factor"]
    cin = width
    for s, n in enumerate(net["resnet_units"]):
        cout, cmid = width * 4 * 2 ** s, width * 2 ** s
        for i in range(n):
            yield (f"block{s + 1}", f"unit{i + 1}", cin if i == 0 else cout,
                   cout, cmid, 2 if (s > 0 and i == 0) else 1)
        cin = cout


def shapes(net) -> Dict[str, Tuple[int, ...]]:
    """Every tensor's name and shape, in the published module's order."""
    out = {}
    width, h = 64 * net["width_factor"], net["hidden_size"]
    grid = net["img_size"] // 16
    out["transformer.embeddings.position_embeddings"] = (1, grid * grid, h)
    out[R50 + "root.conv.weight"] = (width, 3, 7, 7)
    out[R50 + "root.gn.weight"] = out[R50 + "root.gn.bias"] = (width,)
    for stage, unit, cin, cout, cmid, stride in _units(net):
        u = f"{R50}body.{stage}.{unit}."
        out[u + "gn1.weight"] = out[u + "gn1.bias"] = (cmid,)
        out[u + "conv1.weight"] = (cmid, cin, 1, 1)
        out[u + "gn2.weight"] = out[u + "gn2.bias"] = (cmid,)
        out[u + "conv2.weight"] = (cmid, cmid, 3, 3)
        out[u + "gn3.weight"] = out[u + "gn3.bias"] = (cout,)
        out[u + "conv3.weight"] = (cout, cmid, 1, 1)
        if stride != 1 or cin != cout:
            out[u + "downsample.weight"] = (cout, cin, 1, 1)
            out[u + "gn_proj.weight"] = out[u + "gn_proj.bias"] = (cout,)
    out["transformer.embeddings.patch_embeddings.weight"] = (
        h, width * 16, 1, 1)
    out["transformer.embeddings.patch_embeddings.bias"] = (h,)
    for i in range(net["num_layers"]):
        b = f"transformer.encoder.layer.{i}."
        out[b + "attention_norm.weight"] = out[b + "attention_norm.bias"] = \
            (h,)
        out[b + "ffn_norm.weight"] = out[b + "ffn_norm.bias"] = (h,)
        out[b + "ffn.fc1.weight"] = (net["mlp_dim"], h)
        out[b + "ffn.fc1.bias"] = (net["mlp_dim"],)
        out[b + "ffn.fc2.weight"] = (h, net["mlp_dim"])
        out[b + "ffn.fc2.bias"] = (h,)
        for lin in ("query", "key", "value", "out"):
            out[b + f"attn.{lin}.weight"] = (h, h)
            out[b + f"attn.{lin}.bias"] = (h,)
    out["transformer.encoder.encoder_norm.weight"] = (h,)
    out["transformer.encoder.encoder_norm.bias"] = (h,)

    def conv_bn(prefix, cin, cout):
        out[prefix + ".0.weight"] = (cout, cin, 3, 3)
        for k in ("weight", "bias") + BUFFERS[:2]:
            out[prefix + f".1.{k}"] = (cout,)
        out[prefix + ".1.num_batches_tracked"] = ()

    conv_bn("decoder.conv_more", h, net["head_channels"])
    outs = list(net["decoder_channels"])
    ins = [net["head_channels"]] + outs[:-1]
    for i, (cin, cout) in enumerate(zip(ins, outs)):
        skip = net["skip_channels"][i] if i < net["n_skip"] else 0
        conv_bn(f"decoder.blocks.{i}.conv1", cin + skip, cout)
        conv_bn(f"decoder.blocks.{i}.conv2", cout, cout)
    out["segmentation_head.0.weight"] = (net["n_class"], outs[-1], 3, 3)
    out[HEAD_BIAS] = (net["n_class"],)
    return out


# --- the forward ---------------------------------------------------------

def _std(w: torch.Tensor) -> torch.Tensor:
    v, m = torch.var_mean(w, dim=[1, 2, 3], keepdim=True, unbiased=False)
    return (w - m) / torch.sqrt(v + 1e-5)


def _gn(x, p, name, groups, eps=1e-6):
    return F.group_norm(x, groups, p[name + ".weight"], p[name + ".bias"],
                        eps)


def _unit(x, p, u, cin, cout, stride):
    residual = x
    if stride != 1 or cin != cout:
        # the projection's GroupNorm: a group per channel, eps 1e-5
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


def _pad_skip(x, right):
    """The published skip: the stage's output in the top-left corner of
    a zero (right x right) map."""
    feat = torch.zeros(x.shape[:2] + (right, right), dtype=x.dtype,
                       device=x.device)
    feat[:, :, :x.shape[2], :x.shape[3]] = x
    return feat


def _resnet(x, p, net):
    in_size = x.shape[2]
    x = F.conv2d(x, _std(p[R50 + "root.conv.weight"]), stride=2, padding=3)
    x = F.relu(_gn(x, p, R50 + "root.gn", 32))
    features = [x]
    x = F.max_pool2d(x, 3, 2, 0)
    stage = 0
    for name, unit, cin, cout, cmid, stride in _units(net):
        s = int(name[len("block"):]) - 1
        if s != stage:
            features.append(_pad_skip(x, int(in_size / 4 / (stage + 1))))
            stage = s
        x = _unit(x, p, f"{R50}body.{name}.{unit}.", cin, cout, stride)
    return x, features[::-1]


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


def forward(p: Dict[str, torch.Tensor], net, x: torch.Tensor
            ) -> torch.Tensor:
    """NCHW one-channel images at ``img_size`` squared -> NCHW float32
    logits."""
    x = x.repeat(1, 3, 1, 1)
    x, features = _resnet(x, p, net)
    x = F.conv2d(x, p["transformer.embeddings.patch_embeddings.weight"],
                 p["transformer.embeddings.patch_embeddings.bias"])
    x = x.flatten(2).transpose(-1, -2) + \
        p["transformer.embeddings.position_embeddings"]
    for i in range(net["num_layers"]):
        b = f"transformer.encoder.layer.{i}."
        x = x + _attention(_ln(x, p, b + "attention_norm"), p, b,
                           net["num_heads"])
        y = _linear(_ln(x, p, b + "ffn_norm"), p, b + "ffn.fc1")
        x = x + _linear(F.gelu(y), p, b + "ffn.fc2")
    x = _ln(x, p, "transformer.encoder.encoder_norm")
    B, n, h = x.shape
    side = int(round(math.sqrt(n)))
    x = x.permute(0, 2, 1).reshape(B, h, side, side)
    x = _conv_bn_relu(x, p, "decoder.conv_more")
    for i in range(len(net["decoder_channels"])):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        if i < net["n_skip"]:
            x = torch.cat([x, features[i]], dim=1)
        x = _conv_bn_relu(x, p, f"decoder.blocks.{i}.conv1")
        x = _conv_bn_relu(x, p, f"decoder.blocks.{i}.conv2")
    return F.conv2d(x, p["segmentation_head.0.weight"], p[HEAD_BIAS],
                    padding=1)


# --- the seeded bundle ---------------------------------------------------

def _matches(rule: dict, name: str, shape) -> bool:
    prefix = rule.get("prefix")
    return (("suffix" not in rule or name.endswith(rule["suffix"]))
            and ("contains" not in rule or rule["contains"] in name)
            and (prefix is None or name.startswith(tuple(prefix)))
            and ("ndim" not in rule or len(shape) == rule["ndim"])
            and ("ndim_min" not in rule or len(shape) >= rule["ndim_min"]))


def _draw(rule: dict, shape, g: torch.Generator) -> torch.Tensor:
    kind = rule["init"]
    if kind in ("zeros", "calibrated"):
        return torch.zeros(shape, dtype=torch.int64 if shape == () else
                           torch.float32)
    r = torch.randn(shape, generator=g)
    if kind == "fan_in_normal":
        return r * math.sqrt(rule["gain"] / math.prod(shape[1:]))
    if kind == "normal":
        return rule["mean"] + rule["std"] * r
    if kind == "abs_normal":
        return rule["mean"] + rule["std"] * r.abs()
    raise ValueError(f"unknown init {kind!r}")


def _generator(seed: int, stream: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 31 ^ int(state[1]))


def seeded_weights(net: dict, recipe: dict, seed: int, geometry: dict,
                   device) -> Dict[str, torch.Tensor]:
    """The weights ``recipe`` draws from ``seed``, on ``device``, the
    head's bias calibrated on a seeded phantom slice of ``geometry``."""
    out = {}
    for i, (name, shape) in enumerate(shapes(net).items()):
        rule = next(r for r in recipe["rules"] if _matches(r, name, shape))
        out[name] = _draw(rule, shape, _generator(
            seed, recipe["stream"] + i)).to(device)
    S = net["img_size"]
    image, _ = phantoms.sax_phantom(
        S, S, 1, 1, geometry["r_lv"], geometry["wall"], geometry["amp"],
        geometry["noise"], phantoms.seeded_generator(
            seed, recipe["calibration"]["stream"]))
    x = rescale_intensity_torch(torch.from_numpy(image[:, :, 0, 0]).to(
        device), (1.0, 99.0))
    with torch.no_grad():
        out[HEAD_BIAS] = -forward(out, net, x[None, None]).mean(dim=(0, 2, 3))
    return out


def write_bundle(path: str, config: dict, seed: int, geometry: dict,
                 device) -> str:
    """Write the configuration's seeded TransUNet bundle to ``path`` in
    the port's bundle format (kind ``transunet``: tensors in PyTorch's
    layout, parameters under ``params/``, buffers under ``state/``)."""
    with open(os.path.join(ROOT, config["bundle"])) as f:
        recipe = json.load(f)
    set_precision("float32")
    net = config["network"]
    weights = seeded_weights(net, recipe, seed, geometry, device)
    names = {"params": [], "state": []}
    arrays = {}
    for name, t in weights.items():
        tree = "state" if name.rsplit(".", 1)[-1] in BUFFERS else "params"
        names[tree].append(name)
        arrays[tree + "/" + name.replace(".", "/")] = t.cpu().numpy()
    meta = {"format": FORMAT, "kind": "transunet", "cfg": net,
            "names": names, "extra": {}}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def load_weights(bundle: str, device) -> Dict[str, torch.Tensor]:
    """A ``transunet`` bundle's tensors by their state-dict names, on
    ``device`` (the last bundle loaded is kept)."""
    key = (bundle, str(device))
    if key not in _WEIGHTS:
        kind, _, names, params, state = load_model(bundle)
        if kind != "transunet":
            raise ValueError(f"{bundle}: a TransUNet bundle was expected")
        trees = {"params": params, "state": state}
        out = {}
        for tree, keys in names.items():
            for name in keys:
                node = trees[tree]
                for part in name.split("."):
                    node = node[part]
                out[name] = torch.from_numpy(np.asarray(node)).to(device)
        _WEIGHTS.clear()
        _WEIGHTS[key] = out
    return _WEIGHTS[key]


# --- the deploy ----------------------------------------------------------

def rescaled(cine: np.ndarray, device) -> torch.Tensor:
    """The deploy's percentile rescale of a raw cine (X, Y, Z, T), float32
    on ``device``."""
    return rescale_intensity_torch(torch.from_numpy(
        np.ascontiguousarray(cine)).to(device), (1.0, 99.0))


@torch.no_grad()
def segment(x: torch.Tensor, p, net, block: int = 32,
            want_prob: bool = False):
    """Labels (X, Y, Z, T) int16 of a rescaled cine ``x`` (X, Y, Z, T) on
    the weights' device, ``block`` slices a forward; with ``want_prob``
    also the softmax probabilities (X, Y, Z, T, n_class) float32."""
    X, Y, Z, T = x.shape
    x_pre, x_post, y_pre, y_post = pad_to_size(X, Y, net["img_size"])
    slices = F.pad(x.permute(3, 2, 0, 1).reshape(T * Z, 1, X, Y),
                   (y_pre, y_post, x_pre, x_post))
    preds, probs = [], []
    for i in range(0, T * Z, block):
        logits = forward(p, net, slices[i:i + block])[
            :, :, x_pre:x_pre + X, y_pre:y_pre + Y]
        preds.append(torch.argmax(logits, dim=1).to(torch.int16).cpu())
        if want_prob:
            probs.append(torch.softmax(logits, dim=1).cpu())
    pred = torch.cat(preds).reshape(T, Z, X, Y).permute(2, 3, 1, 0).numpy()
    if not want_prob:
        return pred
    prob = torch.cat(probs).reshape(T, Z, -1, X, Y).permute(3, 4, 1, 0, 2)
    return pred, prob.numpy()


def reference_subject(cine: np.ndarray, config: dict, bundle: str, device,
                      precision: str = "float32",
                      want_prob: bool = False) -> dict:
    """{'labels'} (and 'prob' with ``want_prob``) of one raw cine;
    ``precision`` ``tf32`` computes the control."""
    set_precision(precision)
    p = load_weights(bundle, device)
    out = segment(rescaled(cine, device), p, config["network"],
                  want_prob=want_prob)
    if want_prob:
        return {"labels": out[0], "prob": out[1]}
    return {"labels": out}
