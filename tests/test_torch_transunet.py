"""TransUNet R50-ViT-B/16 in the port (``models/transunet.py``) against
its plain reference (``tests/transunet_plain.py``) on seeded random
weights, at a small size on the CPU (hidden 64, 2 layers of 4 heads, MLP
128, one unit a stage, grid 64: the stem's max-pool still gives 15, so
the first skip is zero-padded to 16); at published widths on the
``meta`` device; through its bundle, ``load_segmentation_model``, the
engine's fixed grid and the deploy CLI.  The file imports no JAX, so
its ``cuda`` case runs on the card with ``--noconftest``.

Tolerance of the logits: both sides compute in float32 with TF32 off
and the same standardised weights; they differ in the order of sums
(fused attention against the explicit ``softmax(Q K^T / 8) V``, the
convolution algorithms), which moves logits of magnitude ~2 by ~1e-6.
``atol = rtol = 2e-5`` leaves ten times that; the bfloat16 path differs
by ~1e-2 and fails it (tested).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import transunet_plain as plain
from ukbb_cardiac_tpu_torch.ckpt.convert import (transunet_from_bundle,
                                                 transunet_to_bundle)
from ukbb_cardiac_tpu_torch.ckpt.store import load_model, save_model
from ukbb_cardiac_tpu_torch.cli import deploy_network
from ukbb_cardiac_tpu_torch.infer.deploy import (deploy_subject_sequence,
                                                 load_segmentation_model)
from ukbb_cardiac_tpu_torch.infer.engine import InferenceEngine
from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.models.transunet import (TransUNet,
                                                     TransUNetConfig,
                                                     fold_weight_std)
from ukbb_cardiac_tpu_torch.ops.crop import pad_to_multiple, pad_to_size
from ukbb_cardiac_tpu_torch.ops.intensity import rescale_intensity_torch

SMALL = TransUNetConfig(img_size=64, hidden_size=64, num_heads=4,
                        mlp_dim=128, num_layers=2, resnet_units=(1, 1, 1))
TOL = 2e-5


def _cfg(cfg: TransUNetConfig) -> dict:
    return dataclasses.asdict(cfg)


def _port(cfg, seed, device="cpu"):
    """The port's module holding the reference's seeded weights, folded
    on ``device``; and the weights."""
    sd = plain.random_weights(_cfg(cfg), seed)
    net = TransUNet(cfg)
    net.load_state_dict(sd)
    return fold_weight_std(net.to(device).eval()), sd


def _cine(X, Y, Z, T, seed=0):
    """An int16 SA-like cine: a bright disk that contracts over the
    cycle, a darker ring around it, noise."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    r2 = (xx - X / 2) ** 2 + (yy - Y / 2) ** 2
    out = np.empty((X, Y, Z, T), np.int16)
    for t in range(T):
        r = 0.25 * min(X, Y) * (1 - 0.3 * np.sin(np.pi * t / T) ** 2)
        img = np.where(r2 <= r * r, 900.0, np.where(r2 <= (r + 5) ** 2,
                                                     300.0, 100.0))
        for z in range(Z):
            out[:, :, z, t] = img + rng.normal(0, 60, (X, Y))
    return out


def _reference_labels(cine, sd, cfg, device="cpu"):
    """Labels (X, Y, Z, T) and the top-two logit margin of the plain
    reference on the engine's input: the percentile rescale, a centred
    pad to the grid."""
    X, Y, Z, T = cine.shape
    x = rescale_intensity_torch(torch.from_numpy(cine).to(device),
                                (1.0, 99.0))
    x_pre, x_post, y_pre, y_post = pad_to_size(X, Y, cfg.img_size)
    slices = x.permute(3, 2, 0, 1).reshape(T * Z, 1, X, Y)
    slices = torch.nn.functional.pad(slices, (y_pre, y_post, x_pre, x_post))
    p = {k: v.to(device) for k, v in sd.items()}
    with torch.no_grad():
        logits = plain.forward(p, _cfg(cfg), slices)
    logits = logits[:, :, x_pre:x_pre + X, y_pre:y_pre + Y]
    top = torch.topk(logits, 2, dim=1).values
    margin = (top[:, 0] - top[:, 1]).reshape(T, Z, X, Y)
    pred = logits.argmax(1).reshape(T, Z, X, Y)
    return (pred.permute(2, 3, 1, 0).cpu().numpy(),
            margin.permute(2, 3, 1, 0).cpu().numpy())


def _labels_agree(got, ref, margin):
    """Equal labels wherever the reference's top two logits are more
    than twice the tolerance apart (a nearer tie may flip on rounding);
    and at most a thousandth of the voxels that near."""
    sure = margin > 2 * TOL
    assert np.array_equal(got[sure], ref[sure])
    assert np.mean(~sure) < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_small_transunet_matches_the_plain_reference(seed):
    net, sd = _port(SMALL, seed)
    x = torch.randn(3, 1, 64, 64, generator=torch.Generator().manual_seed(
        seed))
    with torch.no_grad():
        got = net(x)
        ref = plain.forward(sd, _cfg(SMALL), x)
    assert got.shape == (3, 4, 64, 64)
    torch.testing.assert_close(got, ref, atol=TOL, rtol=TOL)
    # random weights, yet the argmax is not one class
    counts = torch.bincount(ref.argmax(1).flatten(), minlength=4)
    assert counts.max() < 0.9 * counts.sum()


def test_unfolded_module_standardises_as_the_fold_does():
    net, sd = _port(SMALL, 2)
    raw = TransUNet(SMALL).eval()
    raw.load_state_dict(sd)
    x = torch.randn(2, 1, 64, 64)
    with torch.no_grad():
        assert torch.equal(raw(x), net(x))
    # the fold leaves the state dict (the published weights) as it was
    assert all(torch.equal(v, sd[k]) for k, v in net.state_dict().items())


def test_bfloat16_path_fails_the_tolerance():
    net, sd = _port(SMALL, 3)
    x = torch.randn(2, 1, 64, 64)
    with torch.no_grad():
        low = net(x, torch.bfloat16)
        ref = plain.forward(sd, _cfg(SMALL), x)
    assert low.dtype == torch.float32
    assert not torch.allclose(low, ref, atol=TOL, rtol=TOL)


def test_published_widths_names_and_shapes_on_meta():
    cfg = TransUNetConfig()
    with torch.device("meta"):
        net = TransUNet(cfg)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == plain.shapes(_cfg(cfg))
    n = sum(p.numel() for p in net.parameters())
    print(f"TransUNet R50-ViT-B/16 at 224^2: {n} parameters")
    assert n == 105_276_356
    assert cfg.grid == 14 and cfg.n_class == 4


def _bundle(tmp_path, cfg=SMALL, seed=4):
    net, sd = _port(cfg, seed)
    names, params, state = transunet_to_bundle(net)
    path = str(tmp_path / "transunet.npz")
    save_model(path, "transunet", cfg, names, params, state)
    return path, net, sd


def test_bundle_round_trip(tmp_path):
    path, net, sd = _bundle(tmp_path)
    kind, cfg, names, params, state = load_model(path)
    assert kind == "transunet" and cfg == SMALL
    back = transunet_from_bundle(params, state, names, cfg)
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k
    model = load_segmentation_model(path, "cpu")
    assert model.grid == 64 and model.n_class == 4 and model.head is None
    x = torch.randn(2, 64, 64, 1)
    with torch.no_grad():
        assert torch.equal(model.forward(x), net(x.permute(0, 3, 1, 2)))


def test_engine_labels_on_a_non_square_cine(tmp_path):
    path, net, sd = _bundle(tmp_path)
    engine = InferenceEngine(load_segmentation_model(path, "cpu"), chunk=8)
    cine = _cine(40, 52, 2, 5)
    got = engine.segment_sequence_dispatch(cine).result()
    assert got.shape == cine.shape and got.flags.f_contiguous
    ref, margin = _reference_labels(cine, sd, SMALL)
    _labels_agree(got, ref, margin)
    # the engine's slice path pads to the same grid
    assert engine.pads(40, 52) == pad_to_size(40, 52, 64)


def test_a_matrix_larger_than_the_grid_raises(tmp_path):
    path, _, _ = _bundle(tmp_path)
    engine = InferenceEngine(load_segmentation_model(path, "cpu"))
    with pytest.raises(ValueError, match="64 x 64 grid"):
        engine.segment_sequence_dispatch(_cine(66, 40, 1, 2))
    with pytest.raises(ValueError, match="grid"):
        engine.run_slices(np.zeros((2, 40, 65), np.float32))


def test_fcn_engine_keeps_its_padding():
    bundle = os.path.join(os.path.dirname(__file__), "fixtures",
                          "bench_weights", "FCN_sa.npz")
    engine = InferenceEngine(load_segmentation_model(bundle, "cpu"))
    assert engine.model.grid is None
    for X, Y in ((192, 208), (204, 208), (180, 192), (300, 17)):
        assert engine.pads(X, Y) == pad_to_multiple(X, Y, 16)


def _subject(root, cine):
    d = os.path.join(root, "1000001")
    os.makedirs(d)
    nim = nifti.Nifti1Image(cine, np.diag([1.8, 1.8, 10.0, 1.0]))
    nifti.save(nim, os.path.join(d, "sa.nii.gz"))
    return d


def test_deploy_subject_sequence_and_cli(tmp_path):
    path, _, sd = _bundle(tmp_path)
    cine = _cine(48, 44, 2, 4, seed=5)
    ref, margin = _reference_labels(cine, sd, SMALL)
    d = _subject(str(tmp_path / "a"), cine)
    engine = InferenceEngine(load_segmentation_model(path, "cpu"))
    assert deploy_subject_sequence(engine, d, "sa") is not None
    seg = np.asarray(nifti.load(os.path.join(d, "seg_sa.nii.gz")).dataobj)
    _labels_agree(seg, ref, margin)
    for f in ("sa_ED", "sa_ES", "seg_sa_ED", "seg_sa_ES"):
        assert os.path.exists(os.path.join(d, f + ".nii.gz"))
    # the deploy CLI takes the bundle as it takes an FCN's
    d2 = _subject(str(tmp_path / "b"), cine)
    deploy_network.main(["--seq_name", "sa", "--data_dir",
                         os.path.dirname(d2), "--model_path", path,
                         "--device", "cpu"])
    seg2 = np.asarray(nifti.load(os.path.join(d2, "seg_sa.nii.gz")).dataobj)
    assert np.array_equal(seg, seg2)


def test_ckpt_load_span_opens_under_the_profiler(tmp_path):
    path, _, _ = _bundle(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        load_segmentation_model(path, "cpu")
    loads = [e for e in prof.events() if e.name == "ukbb.ckpt.load"]
    assert len(loads) == 1


@pytest.mark.cuda
def test_engine_labels_on_the_card(tmp_path):
    """The engine's graphs on the card (first call eager, then the
    captured replay) against the plain reference computed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path, _, sd = _bundle(tmp_path)
    engine = InferenceEngine(load_segmentation_model(path, "cuda"), chunk=8)
    cine = _cine(40, 52, 3, 6)
    ref, margin = _reference_labels(cine, sd, SMALL, "cuda")
    for _ in range(2):
        got = engine.segment_sequence_dispatch(cine).result()
        assert got.flags.f_contiguous
        _labels_agree(got, ref, margin)
    assert len(engine.programs()) == 3
    engine.release_programs()
