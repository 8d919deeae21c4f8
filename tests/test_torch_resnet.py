"""The port's ResNet-FCN and the rest of the FCN deploy against the JAX
package's, on the CPU, float32, at small widths.

Tolerances: train-mode logits 1e-4 and new BN state 1e-6 (batch
statistics amplify float32 noise); inference logits 2e-4 with identical
argmax, the bound ``tests/test_torch_fcn.py`` holds the FCN to; the fused
(folded) head on a ResNet 2e-4; deployed seg NIfTIs byte-identical;
``segment_sequence_fused`` labels identical.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ukbb_cardiac_tpu.ckpt import store as jstore
from ukbb_cardiac_tpu.infer.deploy import deploy_dataset as jax_deploy
from ukbb_cardiac_tpu.infer.deploy import \
    load_segmentation_model as jax_load
from ukbb_cardiac_tpu.infer.engine import InferenceEngine as JaxEngine
from ukbb_cardiac_tpu.models import fcn as jfcn
from ukbb_cardiac_tpu_torch.ckpt import convert
from ukbb_cardiac_tpu_torch.cli import deploy_network
from ukbb_cardiac_tpu_torch.infer.deploy import load_segmentation_model
from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
from ukbb_cardiac_tpu_torch.models import fcn as tfcn
from ukbb_cardiac_tpu_torch.models.fused_head import (apply_fcn_fused,
                                                      fold_head)

from phantom import sax_phantom, write_subject

torch.set_num_threads(1)

FCN_SA = os.path.join(os.path.dirname(__file__), "fixtures", "bench_weights",
                      "FCN_sa.npz")
OUTPUTS = ("seg_sa.nii.gz", "sa_ED.nii.gz", "sa_ES.nii.gz",
           "seg_sa_ED.nii.gz", "seg_sa_ES.nii.gz")


def _cfg(bottleneck, n_level=4):
    return jfcn.ResNetConfig(n_class=4, n_level=n_level,
                             n_filter=(4, 8, 16, 16, 32)[:n_level],
                             n_block=(1, 1, 2, 2, 1)[:n_level], same_dim=4,
                             fc=8, use_bottleneck=bottleneck)


def _port_cfg(cfg):
    return tfcn.ResNetConfig(**cfg.__dict__)


def _random_resnet(cfg, seed=0):
    """JAX init plus non-trivial BN parameters and statistics."""
    params, state, names = jfcn.init_resnet(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    for k in params:
        if k.startswith("batch_normalization"):
            c = params[k]["gamma"].shape[0]
            params[k] = {"gamma": (rng.rand(c) + 0.5).astype(np.float32),
                         "beta": (rng.randn(c) * 0.1).astype(np.float32)}
            state[k] = {"moving_mean": (rng.randn(c) * 0.1).astype(
                np.float32),
                "moving_variance": (rng.rand(c) + 0.5).astype(np.float32)}
    return params, state, names


def _image(n=3, size=32, seed=2):
    return np.random.RandomState(seed).rand(n, size, size, 1).astype(
        np.float32)


@pytest.mark.parametrize("bottleneck", [False, True])
def test_resnet_names_and_round_trip(bottleneck):
    cfg = _cfg(bottleneck)
    params, state, names = _random_resnet(cfg)
    assert convert.fcn_names(_port_cfg(cfg)) == names
    net = convert.resnet_from_jax(params, state, names, _port_cfg(cfg))
    assert len(net.state_dict()) == sum(len(v) for v in params.values()) + \
        sum(len(v) for v in state.values())
    p2, s2 = convert.fcn_to_jax(net, names)
    for tree, ref in ((p2, params), (s2, state)):
        assert set(tree) == set(ref)
        for k in ref:
            for kk in ref[k]:
                np.testing.assert_array_equal(tree[k][kk], ref[k][kk])


@pytest.mark.parametrize("bottleneck", [False, True])
def test_resnet_train_forward_matches_jax(bottleneck):
    cfg = _cfg(bottleneck)
    params, state, names = _random_resnet(cfg)
    x = _image()
    ref, ns = jax.jit(lambda p, s, x: jfcn.apply_resnet(
        p, s, names, cfg, x, train=True))(params, state, jnp.asarray(x))
    net = convert.resnet_from_jax(params, state, names, _port_cfg(cfg))
    got = tfcn.apply_fcn(net, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)
    _, new_state = convert.fcn_to_jax(net, names)
    for k in ns:
        for kk in ns[k]:
            np.testing.assert_allclose(new_state[k][kk], ns[k][kk],
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("bottleneck", [False, True])
def test_resnet_inference_and_fused_head_match_jax(bottleneck):
    """Inference logits (concat head) and the folded fused head's, which
    the deploy runs (the CUDA kernel on the card, its plain version
    here)."""
    cfg = _cfg(bottleneck)
    params, state, names = _random_resnet(cfg)
    x = _image()
    ref, _ = jax.jit(lambda p, s, x: jfcn.apply_resnet(
        p, s, names, cfg, x, train=False))(params, state, jnp.asarray(x))
    ref = np.asarray(ref)
    net = convert.resnet_from_jax(params, state, names, _port_cfg(cfg))
    with torch.no_grad():
        got = tfcn.apply_fcn(net, torch.from_numpy(x)).numpy()
        fused = apply_fcn_fused(net, torch.from_numpy(x),
                                fold_head(net)).permute(0, 2, 3, 1).numpy()
    for out in (got, fused):
        np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
        np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def _resnet_bundle(path):
    """A JAX-written ResNet-FCN bundle: 5 levels at narrow widths with the
    trained ``FCN_sa`` weights of the levels and head that the two
    architectures share, so its labels are not noise."""
    _, fcfg, fnames, fparams, fstate, _ = jstore.load_model(FCN_SA)
    cfg = jfcn.ResNetConfig(n_class=4, n_level=5,
                            n_filter=tuple(fcfg.n_filter),
                            n_block=(2, 2, 1, 1, 1), same_dim=32, fc=64)
    params, state, names = jfcn.init_resnet(jax.random.PRNGKey(0), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    pairs = [(a, b) for key in ("levels", "same_dim", "fc")
             for la, lb in zip(names[key], fnames[key])
             for a, b in (zip(la, lb) if key == "levels" else [(la, lb)])]
    for (c, bn), (fc, fbn) in pairs:
        params[c] = fparams[fc]
        params[bn], state[bn] = fparams[fbn], fstate[fbn]
    params[names["out"]] = fparams[fnames["out"]]
    jstore.save_model(path, "resnet", cfg, names, params, state)
    return cfg


def test_resnet_deploy_byte_identical(tmp_path):
    bundle = str(tmp_path / "ResNet_sa.npz")
    _resnet_bundle(bundle)
    ref_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    write_subject(str(ref_dir / "1000000"), X=64, Y=80, Z=3, T=4,
                  rng=np.random.RandomState(0))
    shutil.copytree(ref_dir, port_dir)
    jax_deploy(bundle, str(ref_dir), seq_name="sa")
    deploy_network.main(["--seq_name", "sa", "--data_dir", str(port_dir),
                         "--model_path", bundle, "--device", "cpu"])
    for name in OUTPUTS:
        ref = (ref_dir / "1000000" / name).read_bytes()
        assert (port_dir / "1000000" / name).read_bytes() == ref, name
    model = load_segmentation_model(bundle, "cpu")
    assert isinstance(model.net, tfcn.ResNetFCN) and model.head is not None


@pytest.mark.parametrize("rescale", ["percentile", "zscore", "none"])
def test_segment_sequence_fused_matches_jax(rescale):
    rng = np.random.RandomState(4)
    image, _ = sax_phantom(48, 64, 2, 3, rng=rng)
    if rescale == "none":
        image = image / np.float32(image.max())
    image = image.astype(np.float32)
    ref = JaxEngine(jax_load(FCN_SA)).segment_sequence_fused(image, rescale)
    got = InferenceEngine(load_segmentation_model(
        FCN_SA, "cpu")).segment_sequence_fused(image, rescale)
    assert got.shape == ref.shape == image.shape
    np.testing.assert_array_equal(got, np.asarray(ref))
    with pytest.raises(ValueError, match="rescale"):
        InferenceEngine(load_segmentation_model(FCN_SA, "cpu")) \
            .segment_sequence_fused(image, "minmax")
