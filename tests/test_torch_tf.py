"""TF checkpoints in the port: ``ckpt/tf_reader.py``, ``cli/verify_checkpoint``
and the TF prefixes the deploy CLIs, the aortic trainer and the demo take.

Every checkpoint here is written by TensorFlow itself with genuine
``tf.layers``-style auto-naming (the graphs of ``tests/test_tf_parity.py``:
the reference FCN, U-Net, bidirectional UNet-LSTM, and a U-Net with the
unidirectional ConvLSTM head).  Bounds: the port's bundle equals the JAX
package's conversion array by array, bitwise, with the same ``__meta__``;
the port's forward of it equals the in-graph TF forward within 2e-4
absolute (1e-4 / 1e-3 relative), the JAX package's own bound for the
same graphs; seg NIfTIs deployed from a TF prefix are byte-identical to
the JAX CLI's.  TensorFlow is needed on the converting host only: the
whole file skips without it (the card machine has none).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
tf1 = tf.compat.v1

from ukbb_cardiac_tpu.ckpt.tf_reader import \
    convert_tf_checkpoint as jax_convert
from ukbb_cardiac_tpu.cli import deploy_network as jax_deploy_cli
from ukbb_cardiac_tpu.models import layers as JL
from ukbb_cardiac_tpu_torch.ckpt import convert, tf_reader
from ukbb_cardiac_tpu_torch.ckpt.store import load_model_with_extra
from ukbb_cardiac_tpu_torch.cli import demo_pipeline, deploy_network
from ukbb_cardiac_tpu_torch.cli import verify_checkpoint as vc
from ukbb_cardiac_tpu_torch.infer.deploy_ao import load_aortic_engine
from ukbb_cardiac_tpu_torch.models import fcn as tfcn
from ukbb_cardiac_tpu_torch.models import unet as tunet
from ukbb_cardiac_tpu_torch.models import wrappers
from ukbb_cardiac_tpu_torch.models.convlstm import BiConvLSTM
from ukbb_cardiac_tpu_torch.train import ao as tao

from phantom import write_subject
from tests.fixtures.contrib_convlstm import Conv2DLSTMCell
from tests.test_tf_parity import (CFG, _auto_conv, _auto_conv_bn_relu,
                                  _build_reference_unet,
                                  _reference_biconv_lstm)

torch.set_num_threads(1)

UCFG = tunet.UNetConfig(n_class=3, n_level=3, n_filter=(2, 4, 4),
                        n_block=(1, 2, 1))
N_HIDDEN = 4


def _fcn_graph(seed, shape=(1, 32, 32, 1)):
    """The reference FCN (``network.py:170-230``), TF-named; returns
    (graph, image placeholder, logits)."""
    graph = tf1.Graph()
    with graph.as_default():
        tf1.set_random_seed(seed)
        image = tf1.placeholder(tf1.float32, shape)
        x, feats = image, []
        for l in range(CFG.n_level):
            for i in range(CFG.n_block[l]):
                x = _auto_conv_bn_relu(tf1, x, CFG.n_filter[l], 3,
                                       2 if (l > 0 and i == 0) else 1)
            feats.append(x)
        ups = []
        for l in range(CFG.n_level):
            f = _auto_conv_bn_relu(tf1, feats[l], CFG.same_dim, 1)
            if l > 0:
                factor = 2 ** l
                W = JL.linear_2d(factor * 2 - 1)
                k = np.zeros(W.shape + (CFG.same_dim, CFG.same_dim),
                             np.float32)
                for c in range(CFG.same_dim):
                    k[:, :, c, c] = W
                n = tf1.shape(f)
                f = tf1.nn.conv2d_transpose(
                    f, tf1.constant(k),
                    tf1.stack([n[0], n[1] * factor, n[2] * factor,
                               CFG.same_dim]),
                    strides=[1, factor, factor, 1], padding="SAME")
            ups.append(f)
        x = tf1.concat(ups, axis=-1)
        for _ in range(2):
            x = _auto_conv_bn_relu(tf1, x, CFG.fc, 1)
        logits = _auto_conv(tf1, x, CFG.n_class, 1, use_bias=True)
    return graph, image, logits


def _lstm_graph(seed, bidirectional):
    """The reference UNet-LSTM (``network_ao.py:322-399``) with the
    bidirectional head, or the U-Net with the unidirectional Conv_LSTM
    head (``network_ao.py:214-252``); returns (graph, images, prob)."""
    N, T, X, Y = 1, 3, 32, 32
    graph = tf1.Graph()
    with graph.as_default():
        tf1.set_random_seed(seed)
        images = tf1.placeholder(tf1.float32, [N, T, X, Y, 1])
        _, net = _build_reference_unet(
            tf1, tf1.reshape(images, [N * T, X, Y, 1]), UCFG)
        feats = tf1.reshape(net["conv0_up"], [N, T, X, Y, UCFG.n_filter[0]])
        if bidirectional:
            outputs = _reference_biconv_lstm(
                tf1, Conv2DLSTMCell, feats, [X, Y, UCFG.n_filter[0]],
                N_HIDDEN, T, UCFG.n_class)
        else:
            init = tf1.random_normal_initializer(stddev=0.3)
            with tf1.variable_scope("LSTM"):
                cell = Conv2DLSTMCell([X, Y, UCFG.n_filter[0]], N_HIDDEN,
                                      [3, 3])
                state = cell.zero_state(tf1.shape(feats)[0], tf1.float32)
                outs = []
                for t in range(T):
                    if t > 0:
                        tf1.get_variable_scope().reuse_variables()
                    h, state = cell(feats[:, t], state)
                    with tf1.variable_scope("conv2d"):
                        k = tf1.get_variable(
                            "kernel", [1, 1, N_HIDDEN, UCFG.n_class],
                            initializer=init)
                        b = tf1.get_variable("bias", [UCFG.n_class],
                                             initializer=init)
                        outs.append(tf1.nn.bias_add(tf1.nn.conv2d(
                            h, k, strides=[1, 1, 1, 1], padding="SAME"), b))
                outputs = tf1.stack(outs, axis=1)
        prob = tf1.nn.softmax(outputs)
    return graph, images, prob


def _checkpoint(tmp_path, kind, seed=3):
    """Write a genuine TF checkpoint of ``kind``; returns (prefix, the TF
    forward on a seeded input, that input)."""
    if kind == "fcn":
        graph, ph, out = _fcn_graph(seed)
        x = np.random.RandomState(seed).rand(1, 32, 32, 1)
    elif kind == "unet":
        graph = tf1.Graph()
        with graph.as_default():
            tf1.set_random_seed(seed)
            ph = tf1.placeholder(tf1.float32, [1, 32, 32, 1])
            out, _ = _build_reference_unet(tf1, ph, UCFG)
        x = np.random.RandomState(seed).rand(1, 32, 32, 1)
    else:
        graph, ph, out = _lstm_graph(seed, kind == "unet_lstm")
        x = np.random.RandomState(seed).rand(1, 3, 32, 32, 1)
    x = x.astype(np.float32)
    with graph.as_default(), tf1.Session(graph=graph) as sess:
        sess.run(tf1.global_variables_initializer())
        ref = sess.run(out, {ph: x})
        prefix = str(tmp_path / f"{kind}.ckpt")
        tf1.train.Saver().save(sess, prefix)
    return prefix, ref, x


def _bundle_arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _port_forward(bundle, x):
    kind, cfg, names, params, state, extra = load_model_with_extra(bundle)
    if kind == "fcn":
        net = convert.fcn_from_jax(params, state, names, cfg)
        with torch.no_grad():
            return tfcn.apply_fcn(net, torch.from_numpy(x)).numpy()
    if kind == "unet":
        net = convert.unet_from_jax(params, state, names, cfg)
        with torch.no_grad():
            return tunet.apply_unet(net, torch.from_numpy(x))[0].numpy()
    engine = load_aortic_engine(bundle, "cpu")
    prob = engine.prob_sequence(
        np.transpose(x[0, :, :, :, 0], (1, 2, 0))[:, :, None, :])
    return np.transpose(prob[:, :, 0], (2, 0, 1, 3))[None]


@pytest.mark.parametrize("kind", ["fcn", "unet", "unet_lstm", "conv_lstm"])
def test_tf_bundle_equals_jax_and_tf_forward(tmp_path, kind):
    """The port's conversion of a genuine TF checkpoint equals the JAX
    package's, array by array and meta; its forward equals TF's."""
    prefix, ref, x = _checkpoint(tmp_path, kind)
    ours = tf_reader.convert_tf_checkpoint(prefix, str(tmp_path / "p.npz"))
    theirs = jax_convert(prefix, str(tmp_path / "j.npz"))
    a, b = _bundle_arrays(ours), _bundle_arrays(theirs)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    meta = json.loads(a["__meta__"].tobytes())
    assert meta == json.loads(b["__meta__"].tobytes())
    assert meta["kind"] == {"conv_lstm": "unet_lstm"}.get(kind, kind)
    if kind in ("unet_lstm", "conv_lstm"):
        assert meta["extra"]["bidirectional"] is (kind == "unet_lstm")
    # the default bundle path: the prefix without .ckpt
    assert tf_reader.convert_tf_checkpoint(prefix) == str(
        tmp_path / f"{kind}.npz")
    np.testing.assert_allclose(_port_forward(ours, x), ref, atol=2e-4,
                               rtol=1e-4 if kind in ("fcn", "unet")
                               else 1e-3)


def test_lstm_checkpoint_without_unet_head(tmp_path):
    """A UNet-LSTM checkpoint without the stand-alone U-Net's output conv
    (which the LSTM path does not run) converts; that conv is zero in the
    bundle (the JAX converter keeps its random init there), every other
    array equals the JAX package's."""
    from tensorflow.python.training import py_checkpoint_reader

    prefix, ref, x = _checkpoint(tmp_path, "unet_lstm")
    reader = py_checkpoint_reader.NewCheckpointReader(prefix)
    values = {n: reader.get_tensor(n)
              for n in reader.get_variable_to_shape_map()
              if not n.startswith("UNet/conv_out/")}
    graph = tf1.Graph()
    with graph.as_default():
        tfvars = [tf1.get_variable(n, initializer=v)
                  for n, v in values.items()]
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            cut = str(tmp_path / "cut.ckpt")
            tf1.train.Saver({v.op.name: v for v in tfvars}).save(sess, cut)
    ours = _bundle_arrays(tf_reader.convert_tf_checkpoint(cut))
    theirs = _bundle_arrays(jax_convert(cut, str(tmp_path / "j.npz")))
    head = "params/UNet/conv_out/conv2d/"
    for key in theirs:
        if key.startswith(head):
            assert ours[key].shape == theirs[key].shape
            assert not ours[key].any()
        else:
            np.testing.assert_array_equal(ours[key], theirs[key],
                                          err_msg=key)
    np.testing.assert_allclose(_port_forward(str(tmp_path / "cut.npz"), x),
                               ref, atol=2e-4, rtol=1e-3)


def test_verify_checkpoint_exit_codes(tmp_path, capsys, monkeypatch):
    """0 within tolerance (every FCN layer against the TF ops), 1 on a
    mismatch (a zero tolerance), 2 without tensorflow; the UNet-LSTM's
    probabilities and the --data_dir Dice through the engine."""
    prefix, _, _ = _checkpoint(tmp_path, "fcn")
    assert vc.main(["--model_path", prefix, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Converted" in out and "OK: checkpoint converts" in out
    assert "level0/conv2d" in out and "out/conv2d_" in out
    assert "upsample2" in out

    assert vc.main(["--model_path", prefix, "--atol", "0",
                    "--device", "cpu"]) == 1
    assert "MISMATCH" in capsys.readouterr().out

    root = tmp_path / "data"
    write_subject(str(root / "100"), seqs=("sa",), X=64, Y=64, Z=4, T=3)
    assert vc.main(["--model_path", str(tmp_path / "fcn.npz"),
                    "--data_dir", str(root), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Using converted bundle" in out
    assert "100: ED port-vs-TF Dice class1=" in out

    lstm, _, _ = _checkpoint(tmp_path, "unet_lstm")
    assert vc.main(["--model_path", lstm, "--device", "cpu"]) == 0
    assert "UNet-LSTM prob max" in capsys.readouterr().out

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    fp = str(tmp_path / "fp.json")
    assert vc.main(["--model_path", str(tmp_path / "fcn.npz"),
                    "--fingerprint", fp, "--device", "cpu"]) == 2
    out = capsys.readouterr().out
    assert "tensorflow not importable" in out and "Fingerprinted" in out
    assert vc.main(["--fingerprint_diff", fp, fp]) == 0


def test_deploy_network_from_tf_prefix_matches_jax(tmp_path):
    """Both deploy CLIs given one TF prefix: the port converts it and
    writes seg NIfTIs byte-identical to the JAX CLI's."""
    graph, _, _ = _fcn_graph(7, shape=(None, 64, 64, 1))
    with graph.as_default(), tf1.Session(graph=graph) as sess:
        sess.run(tf1.global_variables_initializer())
        prefix = str(tmp_path / "model" / "FCN_sa.ckpt")
        tf1.train.Saver().save(sess, prefix)
    ref_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    write_subject(str(ref_dir / "1"), X=64, Y=64, Z=3, T=4,
                  rng=np.random.RandomState(2))
    shutil.copytree(ref_dir, port_dir)
    jax_deploy_cli.main(["--data_dir", str(ref_dir), "--model_path", prefix])
    os.remove(str(tmp_path / "model" / "FCN_sa.npz"))
    deploy_network.main(["--data_dir", str(port_dir), "--model_path", prefix,
                         "--device", "cpu"])
    for name in ("seg_sa.nii.gz", "seg_sa_ED.nii.gz", "seg_sa_ES.nii.gz"):
        assert (ref_dir / "1" / name).read_bytes() == \
            (port_dir / "1" / name).read_bytes(), name


def test_unet_from_tf_checkpoint_restores_and_resolves(tmp_path):
    """The aortic trainer's two-phase restore and the demo's
    ``resolve_model`` take a TF checkpoint through the converter."""
    prefix, _, _ = _checkpoint(tmp_path, "unet")
    net = wrappers.UNetLSTM(tunet.UNet(UCFG),
                            BiConvLSTM(UCFG.n_filter[0], N_HIDDEN,
                                                UCFG.n_class))
    tao.restore_pretrained_unet(net, prefix)
    _, cfg, names, params, state = load_model_with_extra(
        jax_convert(prefix, str(tmp_path / "j.npz")))[:5]
    want = convert.unet_from_jax(params, state, names, cfg)
    for k, v in want.state_dict().items():
        assert torch.equal(net.unet.state_dict()[k], v), k
    os.remove(str(tmp_path / "unet.npz"))
    assert demo_pipeline.resolve_model(str(tmp_path), "unet") == str(
        tmp_path / "unet.npz")
    assert os.path.exists(str(tmp_path / "unet.npz"))
