"""The port's aortic trainer (``train/ao.py``, ``cli/train_network_ao.py``,
the aortic augmenters, the window pool, the training wrappers) against
the JAX package's, on the CPU, float32, at reduced widths.

Tolerances (each test states its own):
- train-mode logits of the U-Net, the temporal U-Net and the UNet-LSTM
  1e-4, their new BN statistics 1e-6;
- gradients of the loss from converted weights: 1e-4 of each tensor's
  largest magnitude (the BatchNorm scales 5e-4), the loss 1e-5 relative;
- Adam with its schedule and the frozen U-Net (``optax.multi_transform``
  with ``set_to_zero`` against an Adam over the LSTM's parameters): 1e-5
  of lr per update;
- the loss over three training steps, each model: 1e-4 relative;
- the phase-2 U-Net's parameters and BN statistics after training:
  bitwise unchanged;
- K steps per call against K single steps, and the pool step against the
  host step: bitwise;
- host window samplers, the host augmenter and the pool's window
  batches: bitwise;
- the device augmenter with injected parameters: images 1e-5, labels
  identical;
- a port-written ``unet_lstm`` bundle read by the JAX package: its
  ``seg_ao`` NIfTI byte-identical to the port's deploy of it.
"""

import dataclasses
import glob
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ukbb_cardiac_tpu.ckpt import store as jstore
from ukbb_cardiac_tpu.infer import deploy_ao as jdeploy
from ukbb_cardiac_tpu.io import nifti as jnifti
from ukbb_cardiac_tpu.models import convlstm as jconvlstm
from ukbb_cardiac_tpu.models import unet as junet
from ukbb_cardiac_tpu.models import wrappers as jwrappers
from ukbb_cardiac_tpu.ops import augment as jaug
from ukbb_cardiac_tpu.ops import resample as jres
from ukbb_cardiac_tpu.train import ao as jao
from ukbb_cardiac_tpu.train import steps as jsteps
from ukbb_cardiac_tpu_torch.ckpt import convert, tf_reader
from ukbb_cardiac_tpu_torch.cli import train_network_ao as tcli
from ukbb_cardiac_tpu_torch.infer import deploy_ao as tdeploy
from ukbb_cardiac_tpu_torch.models import convlstm as tconvlstm
from ukbb_cardiac_tpu_torch.models import unet as tunet
from ukbb_cardiac_tpu_torch.models import wrappers as twrappers
from ukbb_cardiac_tpu_torch.ops import augment as taug
from ukbb_cardiac_tpu_torch.train import ao as tao
from ukbb_cardiac_tpu_torch.train import steps as tsteps
from ukbb_cardiac_tpu_torch.train.device_pool import (
    DeviceCinePool, make_pool_window_multi_step)
from ukbb_cardiac_tpu_torch.train.sa import SubjectCache

from phantom import ao_phantom

torch.set_num_threads(1)

MODELS = ["UNet", "Temporal-UNet", "UNet-LSTM", "UNet-LSTM joint"]
LR = 1e-3
# the train-mode BatchNorm scales' gradients (test_gradients_match_jax)
GAMMA_RTOL = 5e-4


def _jcfg(model, **kw):
    joint = model.endswith("joint")
    return jao.AoTrainConfig(model=model.split()[0], num_filter=2,
                             num_level=3, num_hidden=3, weight_R=2,
                             weight_r=0.5, image_size=32, joint_train=joint,
                             learning_rate=LR, **kw)


def _pcfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    return tao.AoTrainConfig(**{**fields, "device": "cpu", **kw})


def _pucfg(ucfg):
    return tunet.UNetConfig(**dataclasses.asdict(ucfg))


@pytest.fixture(scope="module")
def models():
    """Per model: (JAX cfg, ucfg, params, state, names) with random BN
    parameters and statistics, built by the port's initialiser and
    written out in the JAX layout (the layer names are ``init_unet``'s,
    ``tests/test_torch_ao_train.py::test_unet_names_are_jaxs``)."""
    out = {}
    for i, m in enumerate(MODELS):
        cfg = _jcfg(m)
        ucfg, net, names = tao.init_ao_model(
            _pcfg(cfg), torch.Generator().manual_seed(i))
        g = torch.Generator().manual_seed(100 + i)
        with torch.no_grad():
            for k, v in net.state_dict().items():
                if k.endswith(("gamma", "moving_variance")):
                    v.copy_(torch.rand(v.shape, generator=g) + 0.5)
                elif k.endswith(("beta", "moving_mean")):
                    v.copy_(torch.randn(v.shape, generator=g) * 0.1)
        params, state = tao.bundle_trees(net, names)
        jucfg = junet.UNetConfig(**dataclasses.asdict(ucfg))
        out[m] = (cfg, jucfg, params, state, names)
    return out


def test_unet_names_are_jaxs():
    """The port's initialiser names the layers as ``init_unet`` does (the
    JAX initialiser is only traced, not run)."""
    for m in ("UNet", "Temporal-UNet"):
        cfg = _jcfg(m)
        got = {}

        def init(key):
            got["ucfg"], params, state, got["names"] = jao.init_ao_model(
                cfg, key)
            return params, state

        jax.eval_shape(init, jax.random.PRNGKey(0))
        ucfg, _, tnames = tao.init_ao_model(_pcfg(cfg))
        assert tnames == got["names"]
        assert dataclasses.asdict(ucfg) == dataclasses.asdict(got["ucfg"])


def _port_net(m, models):
    cfg, ucfg, params, state, names = models[m]
    unet = convert.unet_from_jax(params, state, names, _pucfg(ucfg),
                                 temporal=cfg.model == "Temporal-UNet")
    if cfg.model != "UNet-LSTM":
        return unet
    return twrappers.UNetLSTM(unet, convert.convlstm_from_jax(params, True))


def _layout(net, names):
    """(port key, tree, path) of every tensor of ``net``."""
    if isinstance(net, twrappers.UNetLSTM):
        return ([(f"unet.{k}", t, p) for k, t, p in
                 convert.unet_layout(names)]
                + [(f"lstm.{k}", t, p) for k, t, p in
                   convert.convlstm_layout(True)])
    return convert.unet_layout(names)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _batch(m, n=2, seed=3, size=32):
    rng = np.random.RandomState(seed)
    tw = 1 if m == "UNet" else _jcfg(m).time_window
    image = rng.rand(n, tw, size, size, 1).astype(np.float32)
    label = rng.randint(0, 3, (n, tw, size, size)).astype(np.int32)
    if m == "UNet":
        image, label = image[:, 0], label[:, 0]
    return {"image": image, "label": label}


def _t(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            b.items()}


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("m", MODELS)
def test_train_forward_matches_jax(m, models):
    """Train-mode logits and new BN statistics of each model."""
    cfg, ucfg, params, state, names = models[m]
    net = _port_net(m, models)
    x = _batch(m)["image"]
    train_unet = cfg.model != "UNet-LSTM" or cfg.joint_train
    if cfg.model == "UNet":
        want, _, ns = junet.apply_unet(params, state, names, ucfg, x, True)
        got, _ = tunet.apply_unet(net, torch.from_numpy(x), train=True)
    elif cfg.model == "Temporal-UNet":
        want, _, ns = junet.apply_temporal_unet(params, state, names, ucfg,
                                                x, True)
        got, _ = tunet.apply_temporal_unet(net, torch.from_numpy(x),
                                           train=True)
    else:
        feats, ns = jwrappers.unet_lstm_features(params, state, names, ucfg,
                                                 x, train_unet)
        want = jconvlstm.apply_biconv_lstm(params, feats)
        with torch.set_grad_enabled(train_unet):
            tf = twrappers.unet_lstm_features(net.unet, torch.from_numpy(x),
                                              train=train_unet)
        got = tconvlstm.apply_biconv_lstm(net.lstm, tf)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    unet = net.unet if isinstance(net, twrappers.UNetLSTM) else net
    sd = unet.state_dict()
    for key, tree, path in convert.unet_layout(names):
        if tree == "state":
            ref = (_get(ns, path) if train_unet else _get(state, path))
            np.testing.assert_allclose(sd[key].numpy(), ref, atol=1e-6,
                                       err_msg=key)


# ---------------------------------------------------------- gradients

def _port_grads(m, models, batch):
    net = _port_net(m, models)
    loss, _ = tao.make_ao_loss(_pcfg(models[m][0]), net)(_t(batch), 0)
    loss.backward()
    return net, float(loss.detach())


@pytest.mark.parametrize("m", MODELS)
def test_gradients_match_jax(m, models):
    """Loss and gradients of make_ao_loss from the same weights and batch.
    A frozen U-Net takes no gradient in the port (its JAX gradients are
    zeroed by the optimizer instead).

    Each tensor is held to JAX's within 1e-4 of its largest magnitude,
    but the BatchNorm scales (``gamma``) within GAMMA_RTOL: on these
    2-channel train-mode layers a gamma's gradient sums some 18k products
    that largely cancel, and JAX's own float32 gradient there was up to
    4.3e-4 of the largest from a float64 one (the port's float32 up to
    1.1e-4); three gammas, one per model but the frozen one, are more
    than 1e-4 apart (1.05e-4 to 3.6e-4)."""
    cfg, ucfg, params, state, names = models[m]
    batch = _batch(m)
    jloss = jao.make_ao_loss(cfg, ucfg, names)
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), state,
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    net, tl = _port_grads(m, models, batch)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    frozen = cfg.model == "UNet-LSTM" and not cfg.joint_train
    tparams = dict(net.named_parameters())
    n_checked = 0
    for key, tree, path in _layout(net, names):
        if tree != "params":
            continue
        p = tparams[key]
        if frozen and key.startswith("unet."):
            assert p.grad is None, key
            continue
        want = _get(jg, path)
        if p.grad is None:  # the U-Net's own logits feed no LSTM loss
            assert key.startswith("unet.out") and not want.any(), key
            continue
        got = convert.to_jax(p.grad, path)
        rtol = GAMMA_RTOL if path[-1] == "gamma" else 1e-4
        np.testing.assert_allclose(got, want, rtol=0, err_msg=key,
                                   atol=rtol * np.abs(want).max())
        n_checked += 1
    assert n_checked >= (6 if frozen else 20)


# -------------------------------------------------------------- Adam

def test_scheduled_adam_with_frozen_unet_matches_optax(models):
    """The JAX optimizer (LSTM-only multi_transform, lr decay after step
    2) and the port's (Adam over the LSTM's parameters) from the same
    gradients: every parameter within 1e-5 of lr per update; the U-Net's
    unchanged in both."""
    m = "UNet-LSTM"
    cfg, ucfg, params, state, names = models[m]
    cfg = dataclasses.replace(cfg, reduce_lr_after=[2])
    jopt = jao.make_ao_optimizer(cfg, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    net = _port_net(m, models)
    topt = tao.make_ao_optimizer(_pcfg(cfg), net)
    assert isinstance(topt, tsteps.ScheduledAdam)
    assert {id(p) for g in topt.param_groups for p in g["params"]} == {
        id(p) for p in net.lstm.parameters()}
    tparams = dict(net.named_parameters())
    layout = _layout(net, names)
    rng = np.random.RandomState(4)
    for i in range(4):
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)
                                  * 1e-3), jp)
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        for key, tree, path in layout:
            if tree == "params":
                tparams[key].grad = convert.to_port(_get(g, path), path)
        topt.step()
        for key, tree, path in layout:
            if tree != "params":
                continue
            got = convert.to_jax(tparams[key], path)
            np.testing.assert_allclose(got, _get(jp, path), rtol=1e-6,
                                       atol=(i + 1) * 1e-5 * LR,
                                       err_msg=key)
            if key.startswith("unet."):
                np.testing.assert_array_equal(got, _get(params, path))


# ---------------------------------------------------- training steps

@pytest.mark.parametrize("m", ["UNet", "Temporal-UNet", "UNet-LSTM"])
def test_loss_trajectory_matches_jax(m, models):
    """Three steps through each package's step builder from the same
    weights and batches: the losses within 1e-4 relative."""
    cfg, ucfg, params, state, names = models[m]
    batches = [_batch(m, seed=s) for s in range(3)]
    jopt = jao.make_ao_optimizer(cfg, params)
    jstep = jsteps.make_train_step(jao.make_ao_loss(cfg, ucfg, names), jopt)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s, o = state, jopt.init(p)
    jl = []
    for i, b in enumerate(batches):
        p, s, o, loss, _ = jstep(p, s, o, {k: jnp.asarray(v) for k, v in
                                           b.items()},
                                 jax.random.PRNGKey(i + 1))
        jl.append(float(loss))
    net = _port_net(m, models)
    pcfg = _pcfg(cfg)
    tstep = tsteps.make_train_step(tao.make_ao_loss(pcfg, net),
                                   tao.make_ao_optimizer(pcfg, net))
    tl = [float(tstep(_t(b), i + 1)[0]) for i, b in enumerate(batches)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_phase2_unet_bitwise_unchanged(models):
    """Two-phase training updates the LSTM only: after steps (device
    augmentation on) the U-Net's parameters and BN statistics are the
    very same bits, the LSTM's are not."""
    m = "UNet-LSTM"
    net = _port_net(m, models)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    pcfg = _pcfg(models[m][0])
    step = tsteps.make_train_step(
        tao.make_ao_loss(pcfg, net, device_augment=True),
        tao.make_ao_optimizer(pcfg, net))
    for i in range(3):
        step(_t(_batch(m, seed=i)), i + 1)
    after = net.state_dict()
    for k, v in before.items():
        if k.startswith("unet."):
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["lstm.forward_cell.weight"],
                           before["lstm.forward_cell.weight"])


@pytest.mark.parametrize("m", ["UNet", "UNet-LSTM joint"])
def test_k_steps_equal_single_steps_bitwise(m, models):
    K = 3
    batches = [_batch(m, seed=s) for s in range(K)]
    if m == "UNet":  # window-grouped, as device augmentation takes them
        batches = [{k: v[:, None] for k, v in b.items()} for b in batches]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    nets, losses = [], []
    for multi in (False, True):
        net = _port_net(m, models)
        pcfg = _pcfg(models[m][0])
        loss_fn = tao.make_ao_loss(pcfg, net, device_augment=True)
        opt = tao.make_ao_optimizer(pcfg, net)
        seeds = [7, 8, 9]
        if multi:
            got, _ = tsteps.make_multi_train_step(loss_fn, opt)(
                _t(stacked), seeds)
        else:
            step = tsteps.make_train_step(loss_fn, opt)
            got = torch.stack([step(_t(b), s)[0]
                               for b, s in zip(batches, seeds)])
        nets.append(net)
        losses.append(got)
    assert torch.equal(losses[0], losses[1])
    for (k, a), b in zip(nets[0].state_dict().items(),
                         nets[1].state_dict().values()):
        assert torch.equal(a, b), k


# ------------------------------------------------------ augmentation

def _params(n, seed):
    rng = np.random.RandomState(seed)
    p = {"shift": rng.randn(n, 2).astype(np.float32) * 3,
         "rotate": rng.randn(n).astype(np.float32) * 10,
         "scale": (1 + rng.randn(n) * 0.2).astype(np.float32),
         "intensity": (1 + rng.randn(n) * 0.1).astype(np.float32),
         "flip_x": rng.rand(n) >= 0.5}
    # a right angle at unit scale: integer coordinates, .5 ties on the
    # even grid, where the labels' rounding rule shows
    p["rotate"][0], p["scale"][0] = 90.0, 1.0
    p["shift"][0] = [0.5, -1.5]
    return p


def _jax_window_augment(images, labels, p, flip):
    """``aortic_data_augmenter_jax`` with the drawn parameters injected:
    one transform and one flip per window."""
    out_i, out_l = [], []
    for b in range(images.shape[0]):
        mat, off = jaug._affine_from_params(
            images.shape[2], images.shape[3], jnp.asarray(p["shift"][b]),
            jnp.asarray(p["rotate"][b]), jnp.asarray(p["scale"][b]))
        im = jnp.stack([jres.affine_transform_2d(
            jnp.asarray(images[b, t, :, :, 0]), mat, off, order=1)
            for t in range(images.shape[1])])[..., None] * p["intensity"][b]
        la = jnp.stack([jres.affine_transform_2d(
            jnp.asarray(labels[b, t], jnp.float32), mat, off, order=0)
            for t in range(images.shape[1])]).astype(jnp.int32)
        if flip:
            fx = bool(p["flip_x"][b])
            im = im[:, ::-1] if fx else im[:, :, ::-1]
            la = la[:, ::-1] if fx else la[:, :, ::-1]
        out_i.append(np.asarray(im))
        out_l.append(np.asarray(la))
    return np.stack(out_i), np.stack(out_l)


@pytest.mark.parametrize("flip", [False, True])
def test_device_augmenter_with_injected_params(flip):
    rng = np.random.RandomState(1)
    images = rng.rand(3, 4, 24, 28, 1).astype(np.float32)
    labels = rng.randint(0, 3, (3, 4, 24, 28)).astype(np.int32)
    p = _params(3, 2)
    ref_i, ref_l = _jax_window_augment(images, labels, p, flip)
    got_i, got_l = taug.aortic_augment_with_params(
        torch.from_numpy(images), torch.from_numpy(labels),
        {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}, flip)
    assert got_i.shape == images.shape and got_l.dtype == torch.int32
    np.testing.assert_allclose(got_i.numpy(), ref_i, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_l.numpy(), ref_l)


def test_device_augmenter_one_transform_per_window():
    """Equal frames stay equal within a window (one transform each);
    windows differ; a reseeded generator repeats the draw."""
    frame = torch.rand(1, 1, 20, 20, 1)
    images = frame.expand(3, 5, 20, 20, 1).contiguous()
    labels = (images[..., 0] * 3).to(torch.int32)
    gen = torch.Generator().manual_seed(5)
    a = taug.aortic_batch_augmenter_torch(gen, images, labels, 1.0, 10.0,
                                          0.2, 0.1, True)
    for b in range(3):
        for t in range(1, 5):
            assert torch.equal(a[0][b, t], a[0][b, 0])
            assert torch.equal(a[1][b, t], a[1][b, 0])
    assert not torch.equal(a[0][0], a[0][1])
    gen.manual_seed(5)
    b = taug.aortic_batch_augmenter_torch(gen, images, labels, 1.0, 10.0,
                                          0.2, 0.1, True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_host_augmenter_bitwise():
    rng = np.random.RandomState(0)
    image = rng.rand(5, 30, 26, 1).astype(np.float32)
    label = rng.randint(0, 3, (5, 30, 26)).astype(np.int32)
    kw = dict(shift=2.0, rotate=10.0, scale=0.2, intensity=0.1, flip=True)
    ref = jaug.aortic_data_augmenter(image, label,
                                     rng=np.random.RandomState(9), **kw)
    got = taug.aortic_data_augmenter(image, label,
                                     rng=np.random.RandomState(9), **kw)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- the data

def _write_dataset(root, n_train=4, T=10, X=40, Y=36):
    """Aortic training subjects (int16 cines, ED/ES-annotated sparse
    labels); the odd ones also have a propagated label; one validation
    subject."""
    rng = np.random.RandomState(0)
    aff = np.diag([1.8, 1.8, 10.0, 1.0])
    for split, n in (("train", n_train), ("validation", 1)):
        for i in range(n):
            d = os.path.join(root, split, f"s{i}")
            os.makedirs(d)
            img, seg = ao_phantom(X, Y, T, rng=rng)
            lab = np.zeros_like(seg)
            for t in (1 + i % 3, 6):
                lab[..., t] = seg[..., t]
            jnifti.save(jnifti.Nifti1Image(img.astype(np.int16), aff),
                        os.path.join(d, "ao.nii.gz"))
            jnifti.save(jnifti.Nifti1Image(lab, aff),
                        os.path.join(d, "label_ao.nii.gz"))
            if i % 2:
                jnifti.save(jnifti.Nifti1Image(seg, aff),
                            os.path.join(d, "label_ao_prop.nii.gz"))
    return root


@pytest.fixture(scope="module")
def ao_dataset(tmp_path_factory):
    return _write_dataset(str(tmp_path_factory.mktemp("ao_ds")))


class _ScriptedRng:
    """Deterministic subject-draw order (cycling) for the samplers."""

    def __init__(self, seq):
        self.seq = list(seq)
        self.i = 0

    def randrange(self, n):
        v = self.seq[self.i % len(self.seq)] % n
        self.i += 1
        return v


def _rng(seed):
    return (_ScriptedRng(seed) if isinstance(seed, (list, tuple))
            else random.Random(seed))


@pytest.mark.parametrize("tw,flatten,augment", [(1, True, True),
                                                (3, False, True),
                                                (5, False, False)])
def test_host_samplers_bitwise(ao_dataset, tw, flatten, augment):
    """get_random_batch_ao and the window-pool sampler draw byte-identical
    batches to the JAX package's from the same seed, the subject cache on
    and off."""
    train_list = tao.scan_dataset_ao(ao_dataset)["train"]
    assert train_list == jao.scan_dataset_ao(ao_dataset)["train"]
    kw = dict(image_size=32, time_window=tw, flatten=flatten,
              data_augmentation=augment, rotate=10, scale=0.2, shift=1.0,
              intensity=0.1, flip=True)
    ref = jao.get_random_batch_ao(train_list, 3, rng=random.Random(4), **kw)
    cache = SubjectCache(1 << 24)
    for c in (None, cache, cache):
        got = tao.get_random_batch_ao(train_list, 3, rng=random.Random(4),
                                      cache=c, **kw)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert cache.hits > 0
    jpool = jao.make_window_pool_sampler(train_list, 5, rng=random.Random(6),
                                         **kw)
    tpool = tao.make_window_pool_sampler(train_list, 5, rng=random.Random(6),
                                         **kw)
    for _ in range(3):
        a, b = tpool(), jpool()
        for k in ("image", "label"):
            np.testing.assert_array_equal(a[k], b[k])


def _pool_batches(train_list, n, B, tw, seed, n_slots):
    t_max = max(jnifti.read_shape(e[0])[3] for e in train_list)
    pool = DeviceCinePool(n_slots, t_max, 32, 32, "cpu")
    sample = tao.make_device_window_sampler(train_list, B, pool,
                                            image_size=32, time_window=tw,
                                            rng=_rng(seed))
    img, lab = pool.snapshot()
    flat_i, flat_l = img.reshape(-1, 32, 32), lab.reshape(-1, 32, 32)
    out = []
    for _ in range(n):
        b = sample()
        base = torch.from_numpy(b["slot"]).long()[:, None] * t_max
        # gather before the pins go, as the trainer's step does
        out.append({"image": flat_i[base + torch.from_numpy(b["tidx"])]
                    [..., None].numpy().copy(),
                    "label": flat_l[base + torch.from_numpy(b["lidx"])]
                    .numpy().copy()})
        for s in b["slot"]:
            pool.unpin(int(s))
    return out, pool


@pytest.mark.parametrize("seed,n_slots,evicts", [
    (7, 4, False), ([0, 1, 2, 3], 2, True)])
def test_pool_windows_bit_identical_to_host(ao_dataset, seed, n_slots,
                                            evicts):
    """Pool gather == the JAX host window-pool sampler with compact
    transfer, window for window (propagated and repeated-centre labels);
    a 2-slot pool over 4 subjects forces LRU eviction."""
    train_list = tao.scan_dataset_ao(ao_dataset)["train"]
    n = 8 if evicts else 4
    jsample = jao.make_window_pool_sampler(train_list, 3, image_size=32,
                                           time_window=3, rng=_rng(seed))
    host = [jsample() for _ in range(n)]
    dev, pool = _pool_batches(train_list, n, 3, 3, seed, n_slots)
    for hb, db in zip(host, dev):
        np.testing.assert_array_equal(hb["label"].astype(np.uint8),
                                      db["label"])
        np.testing.assert_array_equal(hb["image"].astype(np.float16),
                                      db["image"])
    assert (pool.uploads > 4) if evicts else (pool.uploads <= 4)


def test_pool_step_matches_host_step(ao_dataset, models):
    """One K=2 call of make_pool_window_multi_step equals the multi-step
    fed the host sampler's compact batches, bitwise."""
    m = "UNet-LSTM joint"
    train_list = tao.scan_dataset_ao(ao_dataset)["train"]
    jsample = jao.make_window_pool_sampler(train_list, 2, image_size=32,
                                           time_window=3, rng=_rng(3))
    host = [jsample() for _ in range(2)]
    results = []
    for use_pool in (False, True):
        net = _port_net(m, models)
        pcfg = _pcfg(models[m][0])
        loss_fn = tao.make_ao_loss(pcfg, net, device_augment=True)
        opt = tao.make_ao_optimizer(pcfg, net)
        if use_pool:
            pool = DeviceCinePool(4, 10, 32, 32, "cpu")
            sample = tao.make_device_window_sampler(
                train_list, 2, pool, image_size=32, time_window=3,
                rng=_rng(3))
            idx = [sample() for _ in range(2)]
            stacked = {k: torch.from_numpy(np.stack([b[k] for b in idx]))
                       for k in ("slot", "tidx", "lidx")}
            losses, _ = make_pool_window_multi_step(loss_fn, opt)(
                *pool.snapshot(), stacked, [1, 2])
        else:
            stacked = {
                "image": torch.from_numpy(np.stack(
                    [b["image"] for b in host]).astype(np.float16)),
                "label": torch.from_numpy(np.stack(
                    [b["label"] for b in host]).astype(np.uint8))}
            losses, _ = tsteps.make_multi_train_step(loss_fn, opt)(
                stacked, [1, 2])
        results.append((losses, net.state_dict()))
    assert torch.equal(results[0][0], results[1][0])
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k


# ------------------------------------------- bundles, the CLI, deploy

def test_restore_pretrained_unet_from_a_jax_bundle(tmp_path, models,
                                                   monkeypatch):
    cfg, ucfg, params, state, names = models["UNet"]
    path = str(tmp_path / "unet.npz")
    jstore.save_model(path, "unet", ucfg, names, params, state)
    net = _port_net("UNet-LSTM", models)
    tao.restore_pretrained_unet(net, path)
    want = convert.unet_from_jax(params, state, names, _pucfg(ucfg))
    for k, v in want.state_dict().items():
        assert torch.equal(net.unet.state_dict()[k], v), k
    # a TF checkpoint prefix goes through the converter, then the bundle
    # it wrote is restored (tests/test_torch_tf.py converts real ones)
    converted = []
    monkeypatch.setattr(tf_reader, "convert_tf_checkpoint",
                        lambda prefix: converted.append(prefix) or path)
    net = _port_net("UNet-LSTM", models)
    tao.restore_pretrained_unet(net, str(tmp_path / "model.ckpt-100"))
    assert converted == [str(tmp_path / "model.ckpt-100")]
    for k, v in want.state_dict().items():
        assert torch.equal(net.unet.state_dict()[k], v), k


def _train_cli(ao_dataset, tmp_path, model, *extra):
    return tcli.main(["--dataset_dir", ao_dataset, "--device", "cpu",
                      "--image_size", "32", "--num_filter", "2",
                      "--num_level", "3", "--num_hidden", "3",
                      "--weight_R", "2", "--train_iteration", "10",
                      "--checkpoint_dir", str(tmp_path / "ck"),
                      "--model", model, *extra])


def test_cli_two_phases_then_deploy(ao_dataset, tmp_path):
    """UNet, then UNet-LSTM restoring it (the reference profile), then the
    production options; the UNet-LSTM bundle, read by the JAX package,
    deploys to the very same seg_ao bytes as in the port."""
    _, _, _, stats = _train_cli(ao_dataset, tmp_path, "UNet")
    assert stats["iterations"] == 10
    unet_bundle = glob.glob(str(tmp_path / "ck/UNet_ao_*/model-10.npz"))[0]
    net, names, ucfg, stats = _train_cli(
        ao_dataset, tmp_path, "UNet-LSTM", "--model_path", unet_bundle)
    restored = jstore.load_model(unet_bundle)
    bundle = glob.glob(str(tmp_path / "ck/UNet-LSTM_ao_*/model-10.npz"))[0]
    kind, jucfg, jnames, jparams, jstate = jstore.load_model(bundle)[:5]
    assert kind == "unet_lstm" and jnames == restored[2]
    # phase 2 kept the restored U-Net, bit for bit
    for sub, layer in restored[3]["UNet"].items():
        for name, leaves in layer.items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(
                    jparams["UNet"][sub][name][leaf], v)
    log = [json.loads(x) for x in open(os.path.join(
        os.path.dirname(bundle), "train_log.jsonl"))]
    assert log[-1]["iteration"] == 10 and "val_dice_aa" in log[-1]

    _, _, _, stats = _train_cli(
        ao_dataset, tmp_path, "Temporal-UNet", "--batch_windows", "2",
        "--steps_per_dispatch", "5", "--device_augment", "--bf16",
        "--device_windows", "--pool_gb", "0.001")
    assert stats["iterations"] == 10
    assert glob.glob(str(tmp_path / "ck/Temporal-UNet_ao_*/model-10.npz"))

    cine_dir = tmp_path / "deploy"
    img, _ = ao_phantom(40, 36, 6, rng=np.random.RandomState(9))
    segs = {}
    for name in ("jax", "port"):
        d = cine_dir / name / "1"
        d.mkdir(parents=True)
        jnifti.save(jnifti.Nifti1Image(img.astype(np.int16),
                                       np.diag([1.8, 1.8, 10.0, 1.0])),
                    str(d / "ao.nii.gz"))
    jdeploy.deploy_dataset_ao(bundle, str(cine_dir / "jax"))
    tdeploy.deploy_dataset_ao(bundle, str(cine_dir / "port"), device="cpu")
    for name in ("jax", "port"):
        segs[name] = (cine_dir / name / "1" / "seg_ao.nii.gz").read_bytes()
    assert segs["jax"] == segs["port"]


class _Converted(Exception):
    pass


def _refuse_conversion(prefix):
    raise _Converted(prefix)


def test_cli_refusals(ao_dataset, tmp_path, monkeypatch):
    # a mesh needs window batches that divide, as in the JAX trainer
    with pytest.raises(ValueError, match="requires batch_windows"):
        _train_cli(ao_dataset, tmp_path, "UNet", "--mesh_devices", "2")
    with pytest.raises(ValueError, match=r"\(3 % 2 != 0\)"):
        _train_cli(ao_dataset, tmp_path, "UNet", "--mesh_devices", "2",
                   "--batch_windows", "3")
    # a TF --model_path reaches the converter (no longer refused)
    monkeypatch.setattr(tf_reader, "convert_tf_checkpoint",
                        _refuse_conversion)
    with pytest.raises(_Converted, match="model.ckpt-20000"):
        _train_cli(ao_dataset, tmp_path, "UNet-LSTM", "--model_path",
                   str(tmp_path / "model.ckpt-20000"))
    with pytest.raises(ValueError, match="model_path"):
        _train_cli(ao_dataset, tmp_path, "UNet-LSTM")
    with pytest.raises(ValueError, match="batch_windows"):
        _train_cli(ao_dataset, tmp_path, "UNet", "--steps_per_dispatch", "2")
    with pytest.raises(ValueError, match="device_augment"):
        _train_cli(ao_dataset, tmp_path, "UNet", "--batch_windows", "2",
                   "--device_windows")
