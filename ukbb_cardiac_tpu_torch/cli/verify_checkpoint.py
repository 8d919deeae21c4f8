"""One-command released-checkpoint verification.

Counterpart of ``ukbb_cardiac_tpu/cli/verify_checkpoint.py``.  Given a
reference TF checkpoint (``FCN_sa``, ``FCN_la_2ch``, ``FCN_la_4ch``,
``FCN_la_4ch_seg4``, ``UNet-LSTM_ao`` — the files
``demo_pipeline.py:50-54`` downloads) or a converted bundle, it:

1. converts a checkpoint to a bundle (``ckpt/tf_reader.py``) and prints
   the architecture; with ``--fingerprint`` it writes the bundle's
   per-tensor fingerprints (``ckpt/fingerprint.py``);
2. when tensorflow is importable, recomputes the reference forward with
   raw eager ``tf.nn`` ops from the same weights and prints the
   per-layer max-abs activation difference against the port's forward
   on ``--device`` (the FCN's layers; the U-Net's logits; the UNet-LSTM's
   per-frame probabilities through ``infer/deploy_ao.AorticEngine``);
3. with ``--data_dir``, segments each subject's ED frame with the
   bundle through ``infer/engine.InferenceEngine`` (on the card: the
   fused head kernel) and prints per-class Dice between the port's and
   the TF ops' labels.

``--fingerprint_diff A.json B.json`` compares two fingerprint dumps and
exits.  Exit code 0 = everything within tolerance; 1 = mismatch; 2 = could
not run (no tensorflow for steps 2-3).  TensorFlow is needed on the
checking host only, and imported only here, at run time.

    python -m ukbb_cardiac_tpu_torch.cli.verify_checkpoint \\
        --model_path trained_model/FCN_sa --data_dir demo_image
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.ckpt import store
from ukbb_cardiac_tpu_torch.ckpt.fingerprint import (diff_fingerprints,
                                                     write_fingerprint)
from ukbb_cardiac_tpu_torch.models import layers as L


def resolve_prefix(model_path: str) -> str:
    """Accept a TF checkpoint prefix, a directory containing one, or an
    already-converted .npz bundle."""
    if model_path.endswith(".npz"):
        return model_path
    if os.path.isdir(model_path):
        metas = sorted(glob.glob(os.path.join(model_path, "*.meta")))
        if not metas:
            raise FileNotFoundError(
                f"no .meta checkpoint file under {model_path}")
        return metas[-1][:-len(".meta")]
    if os.path.exists(model_path + ".index") or \
            os.path.exists(model_path + ".meta"):
        return model_path
    raise FileNotFoundError(f"no checkpoint at {model_path}")


# --- eager tf.nn reference forwards (weights = converted values) ----------

def _tf_conv_bn_relu(tf, x, params, state, nm, strides=1):
    cname, bname = nm
    x = tf.nn.conv2d(x, np.asarray(params[cname]["kernel"], np.float32),
                     strides=strides, padding="SAME")
    s, p = state[bname], params[bname]
    x = tf.nn.batch_normalization(
        x, np.asarray(s["moving_mean"]), np.asarray(s["moving_variance"]),
        np.asarray(p["beta"]), np.asarray(p["gamma"]), 1e-3)
    return tf.nn.relu(x)


def tf_fcn_layers(tf, params, state, names, cfg, image):
    """Yield (layer_label, activation) through the reference FCN
    (``network.py:170-230``) with eager tf.nn ops."""
    x = tf.constant(image)
    feats = []
    for l in range(cfg.n_level):
        for i, nm in enumerate(names["levels"][l]):
            x = _tf_conv_bn_relu(tf, x, params, state, nm,
                                 2 if (l > 0 and i == 0) else 1)
            yield f"level{l}/{nm[0]}", x
        feats.append(x)
    ups = []
    for l in range(cfg.n_level):
        f = _tf_conv_bn_relu(tf, feats[l], params, state, names["same_dim"][l])
        yield f"same_dim{l}/{names['same_dim'][l][0]}", f
        if l > 0:
            factor = 2 ** l
            sz = factor * 2 - 1
            h = L.linear_1d(sz)
            W = np.outer(h, h).astype(np.float32)
            n = int(f.shape[-1])
            kernel = np.zeros((sz, sz, n, n), np.float32)
            for c in range(n):
                kernel[:, :, c, c] = W
            N, H, Wd, C = [int(v) for v in f.shape]
            f = tf.nn.conv2d_transpose(
                f, kernel, output_shape=[N, H * factor, Wd * factor, C],
                strides=factor, padding="SAME")
            yield f"upsample{l}", f
        ups.append(f)
    x = tf.concat(ups, axis=-1)
    for nm in names["fc"]:
        x = _tf_conv_bn_relu(tf, x, params, state, nm)
        yield f"fc/{nm[0]}", x
    out = params[names["out"]]
    x = tf.nn.conv2d(x, np.asarray(out["kernel"], np.float32),
                     strides=1, padding="SAME") + np.asarray(out["bias"])
    yield f"out/{names['out']}", x


def port_fcn_layers(net, names, cfg, image, device):
    """The same walk through the port's FCN (``models/fcn.py``) on
    ``device``: (layer_label, NHWC numpy activation)."""
    def nhwc(t):
        return t.permute(0, 2, 3, 1).float().cpu().numpy()

    with torch.no_grad():
        x = torch.from_numpy(image).to(device).permute(0, 3, 1, 2)
        x = x.contiguous()
        feats = []
        for l, blocks in enumerate(net.levels):
            for nm, block in zip(names["levels"][l], blocks):
                x = block(x)
                yield f"level{l}/{nm[0]}", nhwc(x)
            feats.append(x)
        ups = []
        for l, f in enumerate(feats):
            f = net.same_dim[l](f)
            yield f"same_dim{l}/{names['same_dim'][l][0]}", nhwc(f)
            if l > 0:
                f = L.transpose_upsample2d(f, 2 ** l)
                yield f"upsample{l}", nhwc(f)
            ups.append(f)
        x = torch.cat(ups, dim=1)
        for nm, block in zip(names["fc"], net.fc):
            x = block(x)
            yield f"fc/{nm[0]}", nhwc(x)
        x = L.conv2d(x, net.out.weight, bias=net.out.bias)
        yield f"out/{names['out']}", nhwc(x)


def tf_unet_forward(tf, params, state, names, cfg, image):
    """Eager tf.nn reference UNet (``network_ao.py:18-64``); returns
    (logits, conv0_up features).  Mirrors ``unet.apply_unet``'s walk of
    the nested names structure exactly."""
    scope = names["scope"]
    p, s = params[scope], state[scope]
    x = tf.constant(image)
    skips = {}
    for l, (sub, level_names) in enumerate(names["down"]):
        for i, nm in enumerate(level_names):
            x = _tf_conv_bn_relu(tf, x, p[sub], s[sub], nm,
                                 2 if (l > 0 and i == 0) else 1)
        skips[l] = x
    for (sub, level_names), l in zip(names["up"],
                                     range(cfg.n_level - 2, -1, -1)):
        cname, bname = level_names[0]
        k = np.asarray(p[sub][cname]["kernel"], np.float32)
        # ours stores flipped (H, W, in, out) correlation kernels
        # (ckpt/tf_reader.py); tf.nn.conv2d_transpose wants (H, W, out, in)
        k_tf = np.ascontiguousarray(k[::-1, ::-1].transpose(0, 1, 3, 2))
        N, H, W, _ = [int(v) for v in x.shape]
        x = tf.nn.conv2d_transpose(
            x, k_tf, output_shape=[N, H * 2, W * 2, int(k.shape[3])],
            strides=2, padding="SAME")
        sb, pb = s[sub][bname], p[sub][bname]
        x = tf.nn.batch_normalization(
            x, np.asarray(sb["moving_mean"]),
            np.asarray(sb["moving_variance"]),
            np.asarray(pb["beta"]), np.asarray(pb["gamma"]), 1e-3)
        x = tf.nn.relu(x)
        x = tf.concat([skips[l], x], axis=-1)
        for nm in level_names[1:]:
            x = _tf_conv_bn_relu(tf, x, p[sub], s[sub], nm)
    sub, cname = names["out"]
    out = p[sub][cname]
    logits = tf.nn.conv2d(x, np.asarray(out["kernel"], np.float32),
                          strides=1, padding="SAME") + np.asarray(out["bias"])
    return logits, x


def tf_unet_lstm_prob(tf, params, state, names, cfg, images_ntxyc, bidir):
    """Eager reference UNet-LSTM forward (``network_ao.py:322-399``)."""
    N, T, X, Y, C = images_ntxyc.shape
    flat = images_ntxyc.reshape(N * T, X, Y, C)
    _, feats = tf_unet_forward(tf, params, state, names, cfg, flat)
    feats = tf.reshape(feats, [N, T, X, Y, int(feats.shape[-1])])

    def cell_seq(cp, xs):
        kernel = np.asarray(cp["kernel"], np.float32)
        biases = np.asarray(cp["biases"], np.float32)
        n_hidden = kernel.shape[-1] // 4
        c = tf.zeros([N, X, Y, n_hidden])
        h = tf.zeros([N, X, Y, n_hidden])
        hs = []
        for x_t in xs:
            g = tf.nn.conv2d(tf.concat([x_t, h], axis=-1), kernel,
                             strides=1, padding="SAME") + biases
            i, j, f, o = tf.split(g, 4, axis=3)
            c = tf.sigmoid(f + 1.0) * c + tf.sigmoid(i) * tf.tanh(j)
            h = tf.tanh(c) * tf.sigmoid(o)
            hs.append(h)
        return hs

    xs = [feats[:, t] for t in range(T)]
    lstm = params["LSTM"]
    if bidir:
        h_fw = cell_seq(lstm["forward"]["conv_2d_lstm_cell"], xs)
        h_bw = cell_seq(lstm["backward"]["conv_2d_lstm_cell"], xs[::-1])
        out = lstm["output"]["conv2d"]
        logits = [tf.nn.conv2d(tf.concat([h_fw[t], h_bw[T - 1 - t]], -1),
                               np.asarray(out["kernel"], np.float32),
                               strides=1, padding="SAME")
                  + np.asarray(out["bias"]) for t in range(T)]
    else:
        hs = cell_seq(lstm["conv_2d_lstm_cell"], xs)
        out = lstm["conv2d"]
        logits = [tf.nn.conv2d(hs[t], np.asarray(out["kernel"], np.float32),
                               strides=1, padding="SAME")
                  + np.asarray(out["bias"]) for t in range(T)]
    return tf.nn.softmax(tf.stack(logits, axis=1)).numpy()


def _dice(a, b, cls):
    from ukbb_cardiac_tpu_torch.ops.metrics import np_categorical_dice

    if not ((a == cls).any() or (b == cls).any()):
        return 1.0  # class absent in both predictions: perfect agreement
    return float(np_categorical_dice(a, b, cls))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model_path", default="",
                        help="TF checkpoint prefix, its directory, or a "
                             "converted .npz bundle (required except "
                             "with --fingerprint_diff)")
    parser.add_argument("--data_dir", default="",
                        help="Subject directories with <seq_name>.nii.gz "
                             "for the Dice check")
    parser.add_argument("--seq_name", default="sa")
    parser.add_argument("--atol", type=float, default=2e-4,
                        help="Max-abs activation tolerance vs the TF ops")
    parser.add_argument("--dice_min", type=float, default=0.999,
                        help="Per-class port-vs-TF label Dice threshold")
    parser.add_argument("--fingerprint", default="", metavar="OUT.json",
                        help="After conversion, write per-tensor content "
                             "fingerprints (name, shape, dtype, sha256, "
                             "moments) to this JSON (ckpt/fingerprint.py); "
                             "diff two dumps with --fingerprint_diff")
    parser.add_argument("--fingerprint_diff", nargs=2, default=None,
                        metavar=("A.json", "B.json"),
                        help="Diff two fingerprint dumps and exit: lists "
                             "missing/extra/changed tensors (exit 1 on "
                             "any difference)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu': where the port's "
                             "forwards run.")
    args = parser.parse_args(argv)

    if args.fingerprint_diff:
        with open(args.fingerprint_diff[0]) as f:
            a = json.load(f)
        with open(args.fingerprint_diff[1]) as f:
            b = json.load(f)
        d = diff_fingerprints(a, b)
        print(json.dumps(d, indent=1))
        return 1 if (d["missing"] or d["extra"] or d["changed"]) else 0

    if not args.model_path:
        parser.error("--model_path is required (except with "
                     "--fingerprint_diff)")
    device = resolve_device(args.device)
    prefix = resolve_prefix(args.model_path)
    if prefix.endswith(".npz"):
        bundle = prefix
        print(f"Using converted bundle {bundle}")
    else:
        from ukbb_cardiac_tpu_torch.ckpt.tf_reader import \
            convert_tf_checkpoint
        bundle = convert_tf_checkpoint(prefix)
        print(f"Converted {prefix} -> {bundle}")
    if args.fingerprint:
        fp = write_fingerprint(bundle, args.fingerprint)
        print(f"Fingerprinted {fp['n_tensors']} tensors -> "
              f"{args.fingerprint}")
    kind, cfg, names, params, state, extra = store.load_model_with_extra(
        bundle)
    print(f"kind={kind} config={cfg}")

    try:
        import tensorflow as tf
    except ImportError:
        print("tensorflow not importable: conversion checked, forward "
              "parity NOT verified. Install tensorflow to complete.")
        return 2

    from ukbb_cardiac_tpu_torch.ckpt import convert

    failures = []
    rng = np.random.RandomState(0)
    if kind == "fcn":
        net = convert.fcn_from_jax(params, state, names, cfg).to(device)
        image = rng.rand(1, 64, 64, 1).astype(np.float32)
        print(f"{'layer':40s} {'max|Δ|':>12s}")
        for (name_tf, a_tf), (name_p, a_p) in zip(
                tf_fcn_layers(tf, params, state, names, cfg, image),
                port_fcn_layers(net, names, cfg, image, device)):
            if name_tf != name_p:
                raise RuntimeError(f"layer walks disagree: {name_tf} vs "
                                   f"{name_p}")
            d = float(np.max(np.abs(a_p - a_tf.numpy())))
            flag = "" if d <= args.atol else "  <-- MISMATCH"
            print(f"{name_tf:40s} {d:12.3e}{flag}")
            if d > args.atol:
                failures.append((name_tf, d))
    elif kind == "resnet":
        print("resnet (unused by the released pipeline): conversion "
              "checked; no TF-op reference walk implemented")
        return 2
    elif kind in ("unet", "unet_lstm"):
        if kind == "unet":
            net = convert.unet_from_jax(params, state, names, cfg).to(device)
            image = rng.rand(1, 64, 64, 1).astype(np.float32)
            ref, _ = tf_unet_forward(tf, params, state, names, cfg, image)
            with torch.no_grad():
                ours = net(torch.from_numpy(image).to(device).permute(
                    0, 3, 1, 2).contiguous())[0]
            ours = ours.permute(0, 2, 3, 1).float().cpu().numpy()
            d = float(np.max(np.abs(ours - ref.numpy())))
            print(f"UNet logits max|Δ| = {d:.3e}")
            if d > args.atol:
                failures.append(("unet_logits", d))
        else:
            from ukbb_cardiac_tpu_torch.infer.deploy_ao import \
                load_aortic_engine
            bidir = bool(extra.get("bidirectional", True))
            seq = rng.rand(1, 4, 64, 64, 1).astype(np.float32)
            ref_prob = tf_unet_lstm_prob(tf, params, state, names, cfg,
                                         seq, bidir)
            eng = load_aortic_engine(bundle, device)
            arr = np.transpose(seq[0, :, :, :, 0], (1, 2, 0))[:, :, None, :]
            ours = eng.prob_sequence(arr, window="full")
            ours_ntxyc = np.transpose(ours[:, :, 0], (2, 0, 1, 3))[None]
            d = float(np.max(np.abs(ours_ntxyc - ref_prob)))
            print(f"UNet-LSTM prob max|Δ| = {d:.3e}")
            if d > args.atol:
                failures.append(("unet_lstm_prob", d))
    else:
        print(f"unknown model kind {kind}")
        return 2

    # --- Dice on real subjects -------------------------------------------
    if args.data_dir and kind != "fcn":
        print(f"NOTE: --data_dir Dice check is implemented for FCN "
              f"checkpoints only; SKIPPED for kind={kind} (the forward "
              "comparison above still ran)")
    if args.data_dir and kind == "fcn":
        from ukbb_cardiac_tpu_torch.infer.deploy import \
            load_segmentation_model
        from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
        from ukbb_cardiac_tpu_torch.io import nifti
        from ukbb_cardiac_tpu_torch.ops.crop import pad_to_multiple
        from ukbb_cardiac_tpu_torch.ops.intensity import rescale_intensity

        engine = InferenceEngine(load_segmentation_model(bundle, device))
        for subject in sorted(os.listdir(args.data_dir)):
            image_name = os.path.join(args.data_dir, subject,
                                      f"{args.seq_name}.nii.gz")
            if not os.path.exists(image_name):
                continue
            image = np.asanyarray(nifti.load(image_name).dataobj)
            if image.ndim == 3:
                image = image[..., None]
            ed = image[:, :, :, 0].astype(np.float32)
            resc = rescale_intensity(ed, (1.0, 99.0))
            pred = engine.segment_volume(resc)
            # the TF-op prediction on the same preprocessed frame
            X, Y = resc.shape[:2]
            x_pre, x_post, y_pre, y_post = pad_to_multiple(X, Y, 16)
            batch = np.pad(np.transpose(resc, (2, 0, 1))[..., None],
                           ((0, 0), (x_pre, x_post), (y_pre, y_post),
                            (0, 0)))
            *_, (_, logits) = tf_fcn_layers(tf, params, state, names, cfg,
                                            batch.astype(np.float32))
            tf_pred = np.transpose(
                np.argmax(logits.numpy(), axis=-1),
                (1, 2, 0))[x_pre:x_pre + X, y_pre:y_pre + Y]
            dices = [(c, _dice(pred, tf_pred, c))
                     for c in range(1, cfg.n_class)]
            line = " ".join(f"class{c}={d:.4f}" for c, d in dices)
            print(f"{subject}: ED port-vs-TF Dice {line}")
            for c, d in dices:
                if d < args.dice_min:
                    failures.append((f"{subject}_dice_class{c}", d))

    if failures:
        print(f"FAILED: {len(failures)} mismatches: {failures[:5]}")
        return 1
    print("OK: checkpoint converts and matches the TF forward within "
          f"atol={args.atol}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
