"""Data-parallel training through the trainers and CLIs
(``train.sa.train`` / ``train.ao.train`` at ``mesh_devices`` N, the CLIs'
``--mesh_devices``), on the CPU with gloo ranks.

- Uneven batches raise the JAX trainers' ``ValueError``s, word for word,
  before any rank starts (K = 1 and K > 1; windows missing or uneven);
  a per-subject batch that cannot split raises in the ranks at its step,
  and ``train`` raises it.
- More ranks than cards raise ``ValueError``; a failing rank fails the
  run, and a rank left waiting in a collective is stopped.
- Two ranks through each trainer CLI write bundles that the JAX package
  loads and that equal the returned nets; the SA bundle fingerprints as
  the single-process writer's bundle of the same weights and Adam state.
  (Ranks against one process step by step: ``tests/test_torch_dp.py``.)
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

import test_torch_dp_ranks as ranks
from ukbb_cardiac_tpu.ckpt import store as jstore
from ukbb_cardiac_tpu.io import nifti as jnifti
from ukbb_cardiac_tpu.train import ao as jao
from ukbb_cardiac_tpu.train import sa as jsa
from ukbb_cardiac_tpu_torch.ckpt import convert, fingerprint, store
from ukbb_cardiac_tpu_torch.cli import train_network as tcli
from ukbb_cardiac_tpu_torch.cli import train_network_ao as tcli_ao
from ukbb_cardiac_tpu_torch.train import ao as tao
from ukbb_cardiac_tpu_torch.train import distributed
from ukbb_cardiac_tpu_torch.train import sa as tsa

from phantom import ao_phantom, sax_phantom

torch.set_num_threads(1)

def _sa_dataset(root, Z=3):
    for k in ("train", "validation"):
        for i in range(2):
            d = os.path.join(root, k, f"{k}{i}")
            os.makedirs(d, exist_ok=True)
            image, seg = sax_phantom(48, 48, Z, 4, r_lv=8.0, wall=3.0,
                                     rng=np.random.RandomState(i))
            affine = np.diag([1.8, 1.8, 10.0, 1.0])
            for fr, t in (("ED", 0), ("ES", 2)):
                jnifti.save(jnifti.Nifti1Image(image[:, :, :, t], affine),
                            os.path.join(d, f"sa_{fr}.nii.gz"))
                jnifti.save(jnifti.Nifti1Image(
                    seg[:, :, :, t].astype(np.float64), affine),
                    os.path.join(d, f"label_sa_{fr}.nii.gz"))


@pytest.fixture(scope="module")
def sa_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_sa"))
    _sa_dataset(root)
    return root


def _ao_dataset(root, n=3, T=8):
    """Aortic subjects annotated at two frames, 40 x 36 x T int16; one
    validation subject."""
    aff = np.diag([1.8, 1.8, 10.0, 1.0])
    rng = np.random.RandomState(0)
    for k, count in (("train", n), ("validation", 1)):
        for i in range(count):
            d = os.path.join(root, k, f"{k}{i}")
            os.makedirs(d, exist_ok=True)
            image, seg = ao_phantom(40, 36, T, rng=rng)
            label = np.zeros_like(seg)
            for t in (1 + i % 3, T // 2 + 1):
                label[..., t] = seg[..., t]
            jnifti.save(jnifti.Nifti1Image(image.astype(np.int16), aff),
                        os.path.join(d, "ao.nii.gz"))
            jnifti.save(jnifti.Nifti1Image(label, aff),
                        os.path.join(d, "label_ao.nii.gz"))


@pytest.fixture(scope="module")
def ao_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_ao"))
    _ao_dataset(root)
    return root


@pytest.mark.parametrize("K", [1, 3])
def test_uneven_slices_raise_as_jax(sa_dataset, tmp_path, K):
    """batch_slices that do not divide over mesh_devices raise the JAX
    trainer's ValueError, at K = 1 too, before any rank starts."""
    kw = dict(seq_name="sa", image_size=48, num_filter=2, num_level=3,
              dataset_dir=sa_dataset, checkpoint_dir=str(tmp_path),
              batch_slices=6, steps_per_dispatch=K, mesh_devices=4)
    with pytest.raises(ValueError) as jerr:
        jsa.train(jsa.SATrainConfig(**kw), max_iterations=1)
    with pytest.raises(ValueError) as terr:
        tsa.train(tsa.SATrainConfig(**kw, device="cpu"), max_iterations=1)
    assert str(terr.value) == str(jerr.value) == (
        "batch_slices must divide evenly over mesh_devices (6 % 4 != 0)")


@pytest.mark.parametrize("windows", [0, 3])
def test_uneven_windows_raise_as_jax(ao_dataset, tmp_path, windows):
    """A mesh without batch_windows, or with batch_windows that do not
    divide, raises the JAX trainer's ValueError."""
    kw = dict(model="UNet", image_size=32, num_filter=2, num_level=3,
              dataset_dir=ao_dataset, checkpoint_dir=str(tmp_path),
              batch_windows=windows, mesh_devices=2)
    with pytest.raises(ValueError) as jerr:
        jao.train(jao.AoTrainConfig(**kw), max_iterations=1)
    with pytest.raises(ValueError) as terr:
        tao.train(tao.AoTrainConfig(**kw, device="cpu"), max_iterations=1)
    assert str(terr.value) == str(jerr.value)
    assert "batch_windows" in str(terr.value)


def test_more_ranks_than_cards_raise(monkeypatch):
    """Ranks on cards: rank r on cuda:r; more ranks than cards raises
    ValueError naming the count, as ``make_mesh`` does.  CPU ranks are
    any number."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.rank_devices(2, "cuda") == [torch.device("cuda", 0),
                                                    torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="has 2"):
        distributed.rank_devices(3, "cuda")
    assert distributed.rank_devices(3, "cpu") == [torch.device("cpu")] * 3


def test_a_failing_rank_fails_the_run():
    """A rank's exception reaches the caller with its type and message;
    the rank left waiting in a collective is stopped."""
    with pytest.raises(KeyError, match="rank 1 fails"):
        distributed.run(ranks.fail_on, (1,), ["cpu"] * 2)


def test_uneven_subject_batch_fails_train(sa_dataset, tmp_path):
    """Per-subject batches (batch_slices 0) of 3 slices over 2 ranks: the
    step that cannot split raises ValueError in the ranks, and so does
    ``train``."""
    cfg = tsa.SATrainConfig(seq_name="sa", image_size=48, num_filter=2,
                            num_level=3, train_batch_size=1,
                            dataset_dir=sa_dataset,
                            checkpoint_dir=str(tmp_path), mesh_devices=2,
                            device="cpu")
    with pytest.raises(ValueError, match="3 % 2 != 0"):
        tsa.train(cfg, max_iterations=2)


# ----------------------------------------------------------------- CLIs

def test_sa_cli_two_ranks_writes_bundles_jax_reads(sa_dataset, tmp_path):
    """``cli.train_network --device cpu --mesh_devices 2`` (production
    options, the slice pool on): its bundle, with Adam state, loads in
    both packages, equals the returned net (rank 0's) and fingerprints as
    the single-process writer's bundle of the same weights."""
    ckpt = tmp_path / "ckpt"
    net, names, mcfg, stats = tcli.main([
        "--dataset_dir", sa_dataset, "--image_size", "48", "--num_filter",
        "2", "--num_level", "3", "--checkpoint_dir", str(ckpt), "--device",
        "cpu", "--train_iteration", "4", "--batch_slices", "6",
        "--steps_per_dispatch", "2", "--pool_gb", "0.01",
        "--device_slices", "--mesh_devices", "2"])
    assert stats["iterations"] == 4
    (model_dir,) = os.listdir(ckpt)
    bundle = str(ckpt / model_dir / "model-4.npz")
    kind, _, jnames, params, state, extra = jstore.load_model(bundle)
    assert kind == "fcn" and extra["iteration"] == 4 and jnames == names
    got, got_state = convert.fcn_to_jax(net, names)
    for tree, want in ((got, params), (got_state, state)):
        for k in want:
            for kk in want[k]:
                np.testing.assert_array_equal(tree[k][kk], want[k][kk])
    lr = 1e-3 * 6 / 20  # the production profile's linear scaling
    opt = jstore.load_opt_state(bundle, optax.adam(lr).init(params))
    assert int(jax.tree_util.tree_leaves(opt)[0]) == 4
    # the single-process writer, fed the same net and Adam state
    kind, mcfg, tnames, tparams, tstate, _ = store.load_model_with_extra(
        bundle)
    again = convert.fcn_from_jax(tparams, tstate, tnames, mcfg)
    adam = torch.optim.Adam(again.parameters(), lr=lr)
    layout = convert.fcn_layout(tnames, mcfg)
    convert.load_adam_leaves(adam, again, layout, store.load_opt_state(bundle))
    path = str(tmp_path / "again.npz")
    tsa.save_checkpoint(path, again, tnames, adam, layout,
                        {"iteration": 4, "seq_name": "sa"})
    a, b = (fingerprint.fingerprint_bundle(p) for p in (path, bundle))
    assert a["n_tensors"] == b["n_tensors"] > 0
    assert fingerprint.diff_fingerprints(a, b) == {
        "missing": [], "extra": [], "changed": []}


def test_ao_cli_two_ranks_writes_a_bundle_jax_reads(ao_dataset, tmp_path):
    """``cli.train_network_ao --device cpu --mesh_devices 2``: a jointly
    trained UNet-LSTM from scratch with the production options (window
    pool, device augmentation, K = 2); the JAX package loads the bundle
    and the port's net equals it."""
    ckpt = tmp_path / "ckpt"
    net, names, ucfg, stats = tcli_ao.main([
        "--dataset_dir", ao_dataset, "--model", "UNet-LSTM",
        "--from_scratch", "--joint_train", "--image_size", "32",
        "--num_filter", "2", "--num_level", "3", "--num_hidden", "3",
        "--weight_R", "2", "--train_iteration", "4", "--checkpoint_dir",
        str(ckpt), "--device", "cpu", "--batch_windows", "2",
        "--steps_per_dispatch", "2", "--device_augment", "--device_windows",
        "--pool_gb", "0.001", "--mesh_devices", "2"])
    assert stats["iterations"] == 4
    (model_dir,) = os.listdir(ckpt)
    bundle = str(ckpt / model_dir / "model-4.npz")
    kind, _, jnames, params, state, extra = jstore.load_model(bundle)
    assert kind == "unet_lstm" and extra["iteration"] == 4
    for got, want in zip(tao.bundle_trees(net, names), (params, state)):
        got, got_def = jax.tree_util.tree_flatten(got)
        want, want_def = jax.tree_util.tree_flatten(want)
        assert got_def == want_def and got
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
