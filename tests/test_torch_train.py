"""The port's FCN trainer (``ukbb_cardiac_tpu_torch.train``) against the
JAX package's, on the CPU, float32, at small widths.

Tolerances (each test states its own):
- train-mode BatchNorm: output 1e-6 absolute + 1e-6 relative, new
  moving statistics 1e-6;
- train-mode FCN logits 1e-4 (batch statistics amplify float32 noise),
  new BN state 1e-6;
- gradients of the loss from converted weights: 1e-4 of each tensor's
  largest magnitude, and the loss 1e-5 relative;
- the Adam update (same gradients into ``optax.adam`` and
  ``torch.optim.Adam``): 1e-5 of lr per update, plus 1e-6 relative.
  optax computes the bias corrections in float32, where ``1 - 0.999``
  keeps only 1.3e-5 of relative accuracy; torch computes them in
  float64, so an early update differs by up to about 8e-6 of lr; the
  moments 1e-6 of each tensor's largest magnitude;
- the loss over three training steps: 1e-4 relative;
- the bf16 profile's loss, gradients and new BN state: their deviation
  from the JAX float32 result within a factor 2 of the JAX bf16
  trainer's, summed over four batches (a float32 and an all-bf16
  control fall outside);
- K steps per call against K single steps: bitwise;
- device-pool batches against the host slice-pool sampler with compact
  transfer, and the host augmenter: bitwise;
- the device augmenter with injected parameters: image 1e-5, labels
  identical;
- ``affine_transform_2d`` / ``warp_image_2d``: order 1 1e-5, order 0
  identical (half-away-from-zero rounding at .5 ties);
- losses 1e-6, metrics 1e-6;
- bundles written by one package and read by the other: arrays equal.
"""

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
from ukbb_cardiac_tpu.io import nifti as jnifti
from ukbb_cardiac_tpu.models import fcn as jfcn
from ukbb_cardiac_tpu.models import layers as jL
from ukbb_cardiac_tpu.models import losses as jlosses
from ukbb_cardiac_tpu.ops import augment as jaug
from ukbb_cardiac_tpu.ops import crop as jcrop
from ukbb_cardiac_tpu.ops import metrics as jmetrics
from ukbb_cardiac_tpu.ops import resample as jres
from ukbb_cardiac_tpu.train import sa as jsa
from ukbb_cardiac_tpu.train import steps as jsteps
from ukbb_cardiac_tpu_torch.ckpt import convert
from ukbb_cardiac_tpu_torch.ckpt import store as tstore
from ukbb_cardiac_tpu_torch.cli import deploy_network as tdeploy_cli
from ukbb_cardiac_tpu_torch.cli import train_network as ttrain_cli
from ukbb_cardiac_tpu_torch.models import fcn as tfcn
from ukbb_cardiac_tpu_torch.models import layers as tL
from ukbb_cardiac_tpu_torch.models import losses as tlosses
from ukbb_cardiac_tpu_torch.ops import augment as taug
from ukbb_cardiac_tpu_torch.ops import crop as tcrop
from ukbb_cardiac_tpu_torch.ops import metrics as tmetrics
from ukbb_cardiac_tpu_torch.ops import resample as tres
from ukbb_cardiac_tpu_torch.train import prefetch as tprefetch
from ukbb_cardiac_tpu_torch.train import sa as tsa
from ukbb_cardiac_tpu_torch.train import steps as tsteps
from ukbb_cardiac_tpu_torch.train.device_pool import (
    DeviceCinePool, make_pool_slice_multi_step)

from phantom import sax_phantom, write_subject

torch.set_num_threads(1)

NARROW = jfcn.FCNConfig(n_class=4, n_level=3, n_filter=(4, 8, 8),
                        n_block=(2, 1, 2), same_dim=4, fc=8)
LR = 1e-3


def _port_cfg(cfg):
    return tfcn.FCNConfig(**{f: getattr(cfg, f) for f in (
        "n_class", "n_level", "n_filter", "n_block", "same_dim", "fc",
        "in_ch")})


def _random_fcn(cfg=NARROW, seed=0):
    """JAX init plus non-trivial BN parameters and statistics."""
    params, state, names = jfcn.init_fcn(jax.random.PRNGKey(seed), cfg)
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


def _batch(n=4, size=32, seed=2):
    rng = np.random.RandomState(seed)
    image = rng.rand(n, size, size, 1).astype(np.float32)
    label = rng.randint(0, 4, (n, size, size)).astype(np.int32)
    return {"image": image, "label": label}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# --------------------------------------------------------------- layers

def test_batch_norm_train_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 7, 6) * 2 + 1).astype(np.float32)  # NCHW
    gamma, beta = rng.rand(5).astype(np.float32) + 0.5, rng.randn(
        5).astype(np.float32)
    mm, mv = rng.randn(5).astype(np.float32), rng.rand(5).astype(
        np.float32) + 0.5
    ref, ns = jL.batch_norm(jnp.asarray(x.transpose(0, 2, 3, 1)),
                            {"gamma": gamma, "beta": beta},
                            {"moving_mean": mm, "moving_variance": mv},
                            train=True)
    tm, tv = torch.from_numpy(mm.copy()), torch.from_numpy(mv.copy())
    got = tL.batch_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                        torch.from_numpy(beta), tm, tv, train=True)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tm.numpy(), ns["moving_mean"], atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), ns["moving_variance"], atol=1e-6)
    # torch's own would update with the unbiased variance: not used
    assert not np.allclose(np.var(x, axis=(0, 2, 3), ddof=1),
                           np.var(x, axis=(0, 2, 3)), rtol=1e-3)


@pytest.mark.parametrize("fused_head", [None, False])
def test_fcn_train_forward_matches_jax(fused_head):
    params, state, names = _random_fcn()
    b = _batch()
    ref, ns = jax.jit(lambda p, s, x: jfcn.apply_fcn(
        p, s, names, NARROW, x, train=True, fused_head=fused_head))(
        params, state, jnp.asarray(b["image"]))
    net = convert.fcn_from_jax(params, state, names, _port_cfg(NARROW))
    got = tfcn.apply_fcn(net, torch.from_numpy(b["image"]), train=True,
                         fused_head=fused_head)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)
    _, new_state = convert.fcn_to_jax(net, names)
    for k in ns:
        for kk in ns[k]:
            np.testing.assert_allclose(new_state[k][kk], ns[k][kk],
                                       atol=1e-6, rtol=0)


def test_init_weights_and_names():
    """The port's init follows ``init_fcn``'s rules (not its draws) and its
    layer names are the JAX package's."""
    cfg = _port_cfg(NARROW)
    _, _, jnames = jfcn.init_fcn(jax.random.PRNGKey(0), NARROW)
    assert convert.fcn_names(cfg) == jnames
    net = tfcn.init_weights(tfcn.FCN(cfg), torch.Generator().manual_seed(0))
    again = tfcn.init_weights(tfcn.FCN(cfg), torch.Generator().manual_seed(0))
    for (k, a), b in zip(net.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    w = net.levels[1][0].weight.detach()
    limit = np.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * 9))
    assert float(w.abs().max()) <= limit and float(w.std()) > limit / 3
    assert torch.all(net.fc[0].gamma == 1) and torch.all(
        net.fc[0].moving_variance == 1)
    assert torch.all(net.out.bias == 0)


# ------------------------------------------------- gradients and Adam

def _jax_grads(params, state, names, batch):
    loss_fn = jsa.make_fcn_loss(names, NARROW)
    (loss, (_, ns)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), state,
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    return float(loss), grads, ns


def test_gradients_match_jax():
    params, state, names = _random_fcn()
    batch = _batch()
    jloss, jgrads, jns = _jax_grads(params, state, names, batch)
    net = convert.fcn_from_jax(params, state, names, _port_cfg(NARROW))
    loss_fn = tsa.make_fcn_loss(net, _port_cfg(NARROW))
    loss, _ = loss_fn(_tbatch(batch), 0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    grads = {k: p.grad for k, p in net.named_parameters()}
    layout = convert.fcn_layout(names, NARROW)
    n = 0
    for key, tree, path in layout:
        if tree != "params":
            continue
        ref = np.asarray(jgrads[path[0]][path[1]])
        got = convert.to_jax(grads[key], path)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=key)
        n += 1
    assert n == len(grads)
    _, new_state = convert.fcn_to_jax(net, names)
    for k in jns:
        for kk in jns[k]:
            np.testing.assert_allclose(new_state[k][kk], jns[k][kk],
                                       atol=1e-6)


BF16_SEEDS = range(4)
BF16_BAND = 2.0


def _phantom_batch(seed):
    """Four 32^2 phantom slices with their true labels: a coherent
    gradient, which random labels on noise do not give."""
    image, seg = sax_phantom(32, 32, 4, 1, r_lv=4 + seed % 3, wall=2,
                             rng=np.random.RandomState(seed))
    return {"image": (image[..., 0].transpose(2, 0, 1)[..., None]
                      / 1000).astype(np.float32),
            "label": seg[..., 0].transpose(2, 0, 1).astype(np.int32)}


def _bf16_deviation(a, b):
    """(loss, gradients, new BN state) of ``a`` against the float32
    reference ``b``: the loss's relative difference, the median over
    tensors of each gradient's relative L2 difference, the state's
    largest absolute difference."""
    (la, ga, sa), (lb, gb, sb) = a, b
    rel = [np.linalg.norm(ga[k] - gb[k]) / np.linalg.norm(gb[k]) for k in gb]
    return np.array([abs(la - lb) / lb, np.median(rel),
                     max(float(np.abs(sa[k][kk] - sb[k][kk]).max())
                         for k in sb for kk in sb[k])])


@pytest.fixture(scope="module")
def bf16_reference():
    """Per seed: weights, batch, and the JAX loss, gradients and new BN
    state at float32 and at bfloat16 (``make_fcn_loss(compute_dtype=
    jnp.bfloat16)``)."""
    fns, out = {}, []
    for seed in BF16_SEEDS:
        params, state, names = _random_fcn(seed=seed)
        layout = convert.fcn_layout(names, NARROW)
        batch = _phantom_batch(seed)
        ref = {}
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            if name not in fns:
                fns[name] = jax.jit(jax.value_and_grad(
                    jsa.make_fcn_loss(names, NARROW, compute_dtype=dt),
                    has_aux=True))
            (loss, (_, ns)), g = fns[name](
                jax.tree_util.tree_map(jnp.asarray, params), state,
                {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.PRNGKey(0))
            ref[name] = (float(loss),
                         {key: np.asarray(g[p[0]][p[1]])
                          for key, tree, p in layout if tree == "params"},
                         jax.tree_util.tree_map(np.asarray, ns))
        out.append((params, state, names, layout, batch, ref))
    return out


@pytest.mark.parametrize("variant", ["port", "float32 control",
                                     "all-bf16 control"])
def test_bf16_step_matches_jax_bf16(bf16_reference, variant, monkeypatch):
    """The bf16 training profile's loss, gradients and new BN state.

    Two bf16 implementations round independently, so the port's bf16
    numbers sit as far from the JAX package's bf16 ones as either sits
    from float32 (about 2 % per gradient tensor at these widths): no
    elementwise bound holds them together and rejects a wrong cast.  The
    bound is on the deviation from the JAX float32 result, summed over
    four phantom batches: the port's must be within a factor
    ``BF16_BAND`` (2) of the JAX bf16 trainer's, in the loss, the
    gradients and the BN state (measured: 1.03, 1.07, 1.10).  A float32
    run (no bf16 at all) falls below the band in all three (8e-4, 4e-5,
    3e-3); an all-bf16 run (BN statistics and the loss in bf16, as a
    wrong cast would have them) falls above it in the loss and the BN
    state (3.28, 3.17).  The activations are bf16, the BN statistics
    and the loss float32, as in JAX.  The median over gradient tensors
    keeps the output bias from deciding the test: JAX sums that gradient
    in bf16 on the CPU, and it is off by up to 0.9 of its size."""
    dtype = None if variant == "float32 control" else torch.bfloat16
    if variant == "all-bf16 control":
        ce, bn = tlosses.softmax_cross_entropy, tL.batch_norm

        def bn_bf16(x, gamma, beta, mm, mv, train=False, group=None):
            if not (train and x.dtype == torch.bfloat16):
                return bn(x, gamma, beta, mm, mv, train, group)
            shape = (1, -1, 1, 1)
            mean = x.mean((0, 2, 3))
            var = ((x - mean.view(shape)) ** 2).mean((0, 2, 3))
            with torch.no_grad():
                mm.copy_(mm * 0.99 + mean.float() * 0.01)
                mv.copy_(mv * 0.99 + var.float() * 0.01)
            return ((x - mean.view(shape))
                    * (torch.rsqrt(var + 1e-3) * gamma.to(x.dtype)).view(
                        shape) + beta.to(x.dtype).view(shape))

        monkeypatch.setattr(tL, "batch_norm", bn_bf16)
        monkeypatch.setattr(tlosses, "softmax_cross_entropy",
                            lambda lg, lb, n: ce(lg.bfloat16(), lb, n))
    port_dev = jax_dev = 0.0
    for params, state, names, layout, batch, ref in bf16_reference:
        net = convert.fcn_from_jax(params, state, names, _port_cfg(NARROW))
        feats = []
        net.levels[-1][-1].register_forward_hook(
            lambda m, i, o: feats.append(o.dtype))
        loss, _ = tsa.make_fcn_loss(net, _port_cfg(NARROW),
                                    compute_dtype=dtype)(_tbatch(batch), 0)
        loss.backward()
        paths = {key: p for key, _, p in layout}
        grads = {k: convert.to_jax(p.grad, paths[k])
                 for k, p in net.named_parameters()}
        _, ns = convert.fcn_to_jax(net, names)
        port_dev = port_dev + _bf16_deviation(
            (float(loss.detach()), grads, ns), ref["f32"])
        jax_dev = jax_dev + _bf16_deviation(ref["bf16"], ref["f32"])
        assert feats == [dtype or torch.float32]
        assert all(b.dtype == torch.float32 for b in net.buffers())
    ratio = port_dev / jax_dev
    inside = (ratio >= 1 / BF16_BAND) & (ratio <= BF16_BAND)
    if variant == "port":
        assert loss.dtype == torch.float32
        assert inside.all(), ratio
    elif variant == "float32 control":
        assert (ratio < 1 / BF16_BAND).all(), ratio
    else:
        assert ratio[0] > BF16_BAND and ratio[2] > BF16_BAND, ratio


def test_adam_update_matches_optax():
    """The same gradients through optax.adam and torch.optim.Adam, three
    updates; then the state maps to optax's leaves and back."""
    params, state, names = _random_fcn()
    net = convert.fcn_from_jax(params, state, names, _port_cfg(NARROW))
    layout = convert.fcn_layout(names, NARROW)
    opt = optax.adam(LR)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ostate = opt.init(jparams)
    topt = torch.optim.Adam(net.parameters(), lr=LR)
    tparams = dict(net.named_parameters())
    rng = np.random.RandomState(5)

    @jax.jit
    def update(g, ostate, jparams):
        upd, ostate = opt.update(g, ostate, jparams)
        return optax.apply_updates(jparams, upd), ostate

    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)
                                  * 1e-3), jparams)
        jparams, ostate = update(g, ostate, jparams)
        for key, tree, path in layout:
            if tree == "params":
                tparams[key].grad = convert.to_port(g[path[0]][path[1]],
                                                    path)
        topt.step()
    got, _ = convert.fcn_to_jax(net, names)
    for k in got:
        for kk in got[k]:
            np.testing.assert_allclose(got[k][kk], np.asarray(jparams[k][kk]),
                                       atol=3 * 1e-5 * LR, rtol=1e-6)
    leaves = convert.adam_leaves(topt, net, layout)
    ref = jax.tree_util.tree_leaves(ostate)
    assert len(leaves) == len(ref) and leaves[0].dtype == np.int32
    assert int(leaves[0]) == int(ref[0]) == 3
    for a, b in zip(leaves[1:], ref[1:]):
        assert a.shape == b.shape
        # torch updates the first moment with lerp, optax as b1*m+(1-b1)*g
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(b)).max())
    fresh = torch.optim.Adam(net.parameters(), lr=LR)
    convert.load_adam_leaves(fresh, net, layout, leaves)
    for a, b in zip(convert.adam_leaves(fresh, net, layout), leaves):
        np.testing.assert_array_equal(a, b)


def test_loss_trajectory_matches_jax():
    """Three training steps through each package's step builder from the
    same weights and batches: the losses within 1e-4 relative."""
    params, state, names = _random_fcn()
    batches = [_batch(seed=s) for s in range(3)]
    jloss_fn = jsa.make_fcn_loss(names, NARROW)
    opt = optax.adam(LR)
    jstep = jsteps.make_train_step(jloss_fn, opt)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s, o = state, opt.init(p)
    jl = []
    for i, b in enumerate(batches):
        p, s, o, loss, _ = jstep(p, s, o, {k: jnp.asarray(v) for k, v in
                                           b.items()},
                                 jax.random.PRNGKey(i + 1))
        jl.append(float(loss))
    net = convert.fcn_from_jax(params, state, names, _port_cfg(NARROW))
    tstep = tsteps.make_train_step(
        tsa.make_fcn_loss(net, _port_cfg(NARROW)),
        torch.optim.Adam(net.parameters(), lr=LR))
    tl = [float(tstep(_tbatch(b), i + 1)[0]) for i, b in enumerate(batches)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]


@pytest.mark.parametrize("device_augment", [False, True])
def test_k_steps_equal_single_steps_bitwise(device_augment):
    params, state, names = _random_fcn()
    K = 3
    batches = {k: np.stack([_batch(seed=s)[k] for s in range(K)])
               for k in ("image", "label")}
    nets, losses = [], []
    for multi in (False, True):
        net = convert.fcn_from_jax(params, state, names, _port_cfg(NARROW))
        loss_fn = tsa.make_fcn_loss(net, _port_cfg(NARROW),
                                    device_augment=device_augment)
        opt = torch.optim.Adam(net.parameters(), lr=LR)
        seeds = [11, 12, 13]
        if multi:
            got, aux = tsteps.make_multi_train_step(loss_fn, opt)(
                _tbatch(batches), seeds)
        else:
            step = tsteps.make_train_step(loss_fn, opt)
            got = torch.stack([step({k: torch.from_numpy(v[i]) for k, v in
                                     batches.items()}, seeds[i])[0]
                               for i in range(K)])
        nets.append(net)
        losses.append(got)
    assert torch.equal(losses[0], losses[1])
    for (k, a), b in zip(nets[0].state_dict().items(),
                         nets[1].state_dict().values()):
        assert torch.equal(a, b), k


def test_validation_refolds_the_head():
    """The deploy's folded head weights go stale with every update: the
    trainer's validation forward folds them again, so it equals the
    training net's own inference forward after a step."""
    from ukbb_cardiac_tpu_torch.infer.engine import SegmentationModel

    params, state, names = _random_fcn()
    net = convert.fcn_from_jax(params, state, names, _port_cfg(NARROW))
    images = _batch()["image"]
    stale = SegmentationModel.from_fcn(net, "cpu")
    step = tsteps.make_train_step(tsa.make_fcn_loss(net, _port_cfg(NARROW)),
                                  torch.optim.Adam(net.parameters(), lr=0.1))
    step(_tbatch(_batch(seed=5)), 1)
    with torch.no_grad():
        want = tfcn.apply_fcn(net, torch.from_numpy(images)).argmax(-1)
        old = stale.forward(torch.from_numpy(images)).argmax(1)
    got = tsa.validation_predict(net, images, "cpu")
    np.testing.assert_array_equal(got, want.numpy())
    assert (old.numpy() != got).any()


def test_adam_with_schedule_matches_optax():
    w = torch.nn.Parameter(torch.zeros(3))
    opt = tsteps.adam_with_schedule([w], 1e-2, reduce_after=[2, 4],
                                    reduce_factor=0.1)
    jopt = jsteps.adam_with_schedule(1e-2, reduce_after=[2, 4])
    jw = jnp.zeros(3)
    js = jopt.init(jw)
    for i in range(6):
        g = np.full(3, 0.5 + i, np.float32)
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        upd, js = jopt.update(jnp.asarray(g), js, jw)
        jw = optax.apply_updates(jw, upd)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                                   rtol=1e-6, atol=(i + 1) * 1e-5 * 1e-2)
    assert tsteps.adam_with_schedule([w], 1e-3).__class__ is tsteps.Adam
    # the schedule through the data-parallel step in a group of one
    # process: its all-reduce and division by one change nothing
    import tempfile

    import torch.distributed as dist

    init = tempfile.mkdtemp(prefix="dp_one_")
    dist.init_process_group("gloo", init_method=f"file://{init}/rdv",
                            world_size=1, rank=0)
    try:
        out = []
        for dp in (False, True):
            w = torch.nn.Parameter(torch.zeros(3))
            opt = tsteps.adam_with_schedule([w], 1e-2, reduce_after=[2, 4])

            def loss_fn(batch, seed, w=w):
                return (w * batch["x"]).sum() ** 2 + w.sum(), {}

            step = (tsteps.make_dp_train_step(loss_fn, opt,
                                              dist.group.WORLD)
                    if dp else tsteps.make_train_step(loss_fn, opt))
            losses = [step({"x": torch.full((3,), 0.5 + i)}, i)[0]
                      for i in range(6)]
            out.append((torch.stack(losses), w.detach().clone()))
        assert torch.equal(out[0][0], out[1][0])
        assert torch.equal(out[0][1], out[1][1])
    finally:
        dist.destroy_process_group()


def test_chunk_lengths_and_seeds():
    class Q:
        def __init__(self):
            self.n = 0

        def next(self):
            self.n += 1
            return {"x": np.full((2,), self.n, np.int32)}

    build = tprefetch.make_chunk_builder(Q(), 4, 13, (5, 0, 6),
                                         tprefetch.make_stage("cpu"))
    it, got = 0, []
    while it < 13:
        k, b, seeds, release = build(it)
        release()
        assert seeds == list(range(it + 1, it + 1 + k))
        assert b["x"].shape == ((k, 2) if k > 1 else (2,))
        got.append(k)
        it += k
    assert got == [4, 1, 1, 4, 2, 1]


# ------------------------------------------------------- data path

@pytest.fixture(scope="module")
def sa_dataset(tmp_path_factory):
    """6 subject-frames (3 subjects x ED/ES), 48x48, mixed Z (4/6)."""
    root = tmp_path_factory.mktemp("sa_ds")
    rng = np.random.RandomState(0)
    aff = np.diag([1.8, 1.8, 10.0, 1.0])
    for i in range(3):
        d = root / "train" / f"s{i}"
        d.mkdir(parents=True)
        Z = 4 if i % 2 else 6
        for fr in ("ED", "ES"):
            img = (rng.rand(52, 50, Z) * 3000).astype(np.int16)
            lab = rng.randint(0, 4, (52, 50, Z)).astype(np.int16)
            jnifti.save(jnifti.Nifti1Image(img, aff),
                        str(d / f"sa_{fr}.nii.gz"))
            jnifti.save(jnifti.Nifti1Image(lab, aff),
                        str(d / f"label_sa_{fr}.nii.gz"))
    return str(root)


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


def _jax_host_batches(train_list, n, B, seed):
    sample = jsa.make_slice_pool_sampler(train_list, B, image_size=48,
                                         rng=_rng(seed))
    return [{"image": b["image"].astype(np.float16),
             "label": b["label"].astype(np.uint8)}
            for b in (sample() for _ in range(n))]


def _pool_batches(train_list, n, B, seed, n_slots):
    z_max = max(jnifti.read_shape(e[0])[2] for e in train_list)
    pool = DeviceCinePool(n_slots, z_max, 48, 48, "cpu")
    sample = tsa.make_device_slice_sampler(train_list, B, pool,
                                           image_size=48, rng=_rng(seed))
    img, lab = pool.snapshot()
    flat_i = img.reshape(-1, 48, 48)
    flat_l = lab.reshape(-1, 48, 48)
    out = []
    for _ in range(n):
        b = sample()
        fi = torch.from_numpy(b["slot"] * z_max + b["zidx"]).long()
        # gather before the pins go, as the trainer's step does
        out.append({"image": flat_i[fi][..., None].numpy().copy(),
                    "label": flat_l[fi].numpy().copy()})
        for s in b["slot"]:
            pool.unpin(int(s))
    return out, pool


@pytest.mark.parametrize("seed,n_slots,evicts", [
    (7, 6, False), ([0, 1, 2, 3, 4, 5], 2, True)])
def test_pool_batches_bit_identical_to_host(sa_dataset, seed, n_slots,
                                            evicts):
    """Pool gather == the JAX host slice-pool sampler with compact
    transfer, slice for slice; a 2-slot pool over 6 subject-frames forces
    LRU eviction."""
    train_list = tsa.scan_dataset(sa_dataset, "sa")["train"]
    assert train_list == jsa.scan_dataset(sa_dataset, "sa")["train"]
    n = 10 if evicts else 5
    host = _jax_host_batches(train_list, n, 5, seed)
    dev, pool = _pool_batches(train_list, n, 5, seed, n_slots)
    for hb, db in zip(host, dev):
        np.testing.assert_array_equal(hb["label"], db["label"])
        np.testing.assert_array_equal(hb["image"], db["image"])
    assert (pool.uploads > 6) if evicts else (pool.uploads <= 6)


def test_pool_step_matches_host_step(sa_dataset):
    """One K=2 call of make_pool_slice_multi_step equals the multi-step
    fed the host sampler's compact batches, bitwise."""
    train_list = tsa.scan_dataset(sa_dataset, "sa")["train"]
    params, state, names = _random_fcn()
    host = _jax_host_batches(train_list, 2, 4, 3)
    results = []
    for use_pool in (False, True):
        net = convert.fcn_from_jax(params, state, names, _port_cfg(NARROW))
        loss_fn = tsa.make_fcn_loss(net, _port_cfg(NARROW),
                                    device_augment=True)
        opt = torch.optim.Adam(net.parameters(), lr=LR)
        if use_pool:
            z_max = max(jnifti.read_shape(e[0])[2] for e in train_list)
            pool = DeviceCinePool(6, z_max, 48, 48, "cpu")
            sample = tsa.make_device_slice_sampler(
                train_list, 4, pool, image_size=48, rng=random.Random(3))
            idx = [sample() for _ in range(2)]
            stacked = {k: torch.from_numpy(np.stack([b[k] for b in idx]))
                       for k in ("slot", "zidx")}
            losses, _ = make_pool_slice_multi_step(loss_fn, opt)(
                *pool.snapshot(), stacked, [1, 2])
        else:
            stacked = {k: torch.from_numpy(np.stack([b[k] for b in host]))
                       for k in ("image", "label")}
            losses, _ = tsteps.make_multi_train_step(loss_fn, opt)(
                stacked, [1, 2])
        results.append((losses, net.state_dict()))
    assert torch.equal(results[0][0], results[1][0])
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k


def test_host_samplers_and_augmenter_identical(sa_dataset):
    """The host sampler with host augmentation draws byte-identical
    batches to the JAX package's from the same seed (SubjectCache on and
    off)."""
    train_list = tsa.scan_dataset(sa_dataset, "sa")["train"]
    kw = dict(image_size=48, data_augmentation=True, rotate=10, scale=0.2,
              shift=2.0, intensity=0.1, flip=True)
    ref = jsa.get_random_batch(train_list, 2, rng=random.Random(4), **kw)
    for cache in (None, tsa.SubjectCache(1 << 24)):
        for _ in range(2 if cache else 1):
            got = tsa.get_random_batch(train_list, 2, rng=random.Random(4),
                                       cache=cache, **kw)
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert cache.hits > 0


def _params(n, seed):
    rng = np.random.RandomState(seed)
    p = {"shift": rng.randn(n, 2).astype(np.float32) * 3,
         "rotate": rng.randn(n).astype(np.float32) * 10,
         "scale": (1 + rng.randn(n) * 0.2).astype(np.float32),
         "intensity": (1 + rng.randn(n) * 0.1).astype(np.float32),
         "flip_x": rng.rand(n) >= 0.5}
    # exact right angles and unit scale: integer source coordinates and
    # .5 ties on the even grid, where the rounding rule shows
    p["rotate"][:2] = [90.0, 0.0]
    p["scale"][:2] = 1.0
    p["shift"][1] = [0.5, -1.5]
    return p


def _jax_augment(image, label, p, flip):
    """``augment._augment_one`` with the drawn parameters injected."""
    imgs, labs = [], []
    for i in range(image.shape[0]):
        m, o = jaug._affine_from_params(
            image.shape[1], image.shape[2], jnp.asarray(p["shift"][i]),
            jnp.asarray(p["rotate"][i]), jnp.asarray(p["scale"][i]))
        im = jnp.stack([jres.affine_transform_2d(
            jnp.asarray(image[i, :, :, c]), m, o, order=1)
            for c in range(image.shape[3])], -1) * p["intensity"][i]
        la = jres.affine_transform_2d(jnp.asarray(label[i], jnp.float32), m,
                                      o, order=0).astype(jnp.int32)
        if flip:
            fx = bool(p["flip_x"][i])
            im = im[::-1] if fx else im[:, ::-1]
            la = la[::-1] if fx else la[:, ::-1]
        imgs.append(np.asarray(im))
        labs.append(np.asarray(la))
    return np.stack(imgs), np.stack(labs)


@pytest.mark.parametrize("flip", [False, True])
def test_device_augmenter_with_injected_params(flip):
    rng = np.random.RandomState(1)
    image = rng.rand(6, 32, 40, 1).astype(np.float32)
    label = rng.randint(0, 4, (6, 32, 40)).astype(np.int32)
    p = _params(6, 2)
    ref_i, ref_l = _jax_augment(image, label, p, flip)
    got_i, got_l = taug.augment_with_params(
        torch.from_numpy(image), torch.from_numpy(label),
        {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}, flip)
    assert got_l.dtype == torch.int32
    np.testing.assert_allclose(got_i.numpy(), ref_i, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_l.numpy(), ref_l)


def test_device_augmenter_draws():
    gen = torch.Generator().manual_seed(3)
    image = torch.rand(5, 16, 16, 1)
    label = torch.randint(0, 4, (5, 16, 16))
    a = taug.data_augmenter_torch(gen, image, label, 1.0, 10.0, 0.2, 0.1,
                                  True)
    gen.manual_seed(3)
    b = taug.data_augmenter_torch(gen, image, label, 1.0, 10.0, 0.2, 0.1,
                                  True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    p = taug.sample_params(torch.Generator().manual_seed(0), 4000, 2.0,
                           10.0, 0.2, 0.1)
    assert float(p["rotate"].abs().max()) <= 30.0 + 1e-5
    assert 8.5 < float(p["rotate"].std()) < 11.5
    assert 0.4 < float(p["flip_x"].float().mean()) < 0.6


@pytest.mark.parametrize("order", [0, 1])
def test_resample_matches_jax(order):
    rng = np.random.RandomState(order)
    image = rng.rand(20, 24).astype(np.float32)
    cases = [(np.array([[0.9, 0.2], [-0.2, 0.9]], np.float32),
              np.array([1.3, -2.7], np.float32)),
             # .5 ties: a half-pixel shift and a 180-degree turn
             (np.eye(2, dtype=np.float32), np.array([0.5, -1.5], np.float32)),
             (-np.eye(2, dtype=np.float32), np.array([19.5, 22.5],
                                                     np.float32))]
    for m, o in cases:
        ref = np.asarray(jres.affine_transform_2d(
            jnp.asarray(image), jnp.asarray(m), jnp.asarray(o), order=order))
        got = tres.affine_transform_2d(torch.from_numpy(image),
                                       torch.from_numpy(m),
                                       torch.from_numpy(o), order).numpy()
        if order == 0:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    disp = (rng.randn(2, 20, 24) * 3).astype(np.float32)
    disp[:, :4] = np.round(disp[:, :4]) + 0.5  # ties
    ref = np.asarray(jres.warp_image_2d(jnp.asarray(image),
                                        jnp.asarray(disp), order=order))
    got = tres.warp_image_2d(torch.from_numpy(image), torch.from_numpy(disp),
                             order).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 if order else 0, rtol=0)


def test_round_half_away_differs_from_torch_round():
    c = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, 2.4])
    assert tres.round_half_away(c).tolist() == [-3, -2, -1, 1, 2, 3, 0, 2]
    assert torch.round(c).tolist() == [-2, -2, -0, 0, 2, 2, 0, 2]


# ------------------------------------------------- losses and metrics

def test_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 5, 6, 7, 3).astype(np.float32)
    labels = rng.randint(0, 3, (2, 5, 6, 7))
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    jlab, tlab = jnp.asarray(labels), torch.from_numpy(labels)
    pairs = [
        (jlosses.softmax_cross_entropy(jl, jlab, 3),
         tlosses.softmax_cross_entropy(tl, tlab, 3)),
        (jlosses.focal_loss(jlab, jl, 3, 0.25),
         tlosses.focal_loss(tlab, tl, 3, 0.25)),
        (jlosses.weighted_temporal_cross_entropy(jl, jlab, 3, 2, 1.5),
         tlosses.weighted_temporal_cross_entropy(tl, tlab, 3, 2, 1.5)),
        (jlosses.centre_frame_cross_entropy(jl, jlab, 3),
         tlosses.centre_frame_cross_entropy(tl, tlab, 3)),
        (jlosses.temporal_window_weights(7, 2, 1.5),
         tlosses.temporal_window_weights(7, 2, 1.5))]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


def test_metrics_match_jax():
    rng = np.random.RandomState(1)
    pred = rng.randint(0, 3, (20, 24, 3))
    truth = rng.randint(0, 3, (20, 24, 3))
    tp, tt = torch.from_numpy(pred), torch.from_numpy(truth)
    np.testing.assert_allclose(
        float(tmetrics.categorical_accuracy(tp, tt)),
        float(jmetrics.categorical_accuracy(pred, truth)), rtol=1e-6)
    for k in (1, 2):
        np.testing.assert_allclose(
            float(tmetrics.categorical_dice(tp, tt, k)),
            float(jmetrics.categorical_dice(pred, truth, k)), rtol=1e-6)
        assert tmetrics.np_categorical_dice(pred, truth, k) == \
            jmetrics.np_categorical_dice(pred, truth, k)
    a = np.zeros((30, 30, 2), np.uint8)
    b = np.zeros((30, 30, 2), np.uint8)
    a[5:20, 6:18] = 1
    b[7:22, 5:16] = 1
    b[..., 1] = 0
    assert tmetrics.distance_metric(a, b, 1.8) == \
        jmetrics.distance_metric(a, b, 1.8)


def test_crop_image_matches_jax():
    image = np.random.RandomState(0).rand(30, 26, 3, 2)
    for cx, cy, size in ((15, 13, 20), (3, 24, 16), (15, 13, 40)):
        np.testing.assert_array_equal(tcrop.crop_image(image, cx, cy, size),
                                      jcrop.crop_image(image, cx, cy, size))
    with pytest.raises(ValueError):
        tcrop.crop_image(np.zeros((4, 4)), 2, 2, 2)


# ----------------------------------------------------------- bundles

def test_port_bundle_read_by_jax(tmp_path):
    """The port writes (after two steps, so Adam's state is not empty);
    the JAX package's ``load_model`` + ``load_opt_state`` read equal
    arrays."""
    params, state, names = _random_fcn()
    net = convert.fcn_from_jax(params, state, names, _port_cfg(NARROW))
    opt = torch.optim.Adam(net.parameters(), lr=LR)
    step = tsteps.make_train_step(tsa.make_fcn_loss(net, _port_cfg(NARROW)),
                                  opt)
    for i in range(2):
        step(_tbatch(_batch(seed=i)), i)
    layout = convert.fcn_layout(names, NARROW)
    path = str(tmp_path / "model-2.npz")
    tsa.save_checkpoint(path, net, names, opt, layout, {"iteration": 2})
    kind, cfg, jnames, jp, js, extra = jstore.load_model(path)
    assert (kind, extra["iteration"]) == ("fcn", 2)
    assert cfg == NARROW and jnames == names
    p, s = convert.fcn_to_jax(net, names)
    for tree, ref in ((p, jp), (s, js)):
        assert set(tree) == set(ref)
        for k in tree:
            for kk in tree[k]:
                np.testing.assert_array_equal(np.asarray(ref[k][kk]),
                                              tree[k][kk])
    template = optax.adam(LR).init(jp)
    restored = jstore.load_opt_state(path, template)
    leaves = convert.adam_leaves(opt, net, layout)
    rl = jax.tree_util.tree_leaves(restored)
    assert int(rl[0]) == 2 and len(rl) == len(leaves)
    for a, b in zip(rl, leaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    # and the port reads its own bundle back
    kind, cfg2, n2, p2, s2 = tstore.load_model(path)
    assert kind == "fcn" and cfg2 == _port_cfg(NARROW)
    for a, b in zip(tstore.load_opt_state(path), leaves):
        np.testing.assert_array_equal(a, b)


def test_unet_and_convlstm_converters_invert():
    """``unet_to_jax`` / ``convlstm_to_jax`` give back the trained
    UNet-LSTM bundle's arrays exactly."""
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "bench_weights", "UNet-LSTM_ao.npz")
    kind, cfg, names, params, state, extra = \
        tstore.load_model_with_extra(path)
    assert kind == "unet_lstm" and extra["bidirectional"]
    unet = convert.unet_from_jax(params, state, names, cfg)
    lstm = convert.convlstm_from_jax(params, True)
    got_p, got_s = convert.unet_to_jax(unet, names)
    got_p.update(convert.convlstm_to_jax(lstm))
    for tree, ref in ((got_p, params), (got_s, state)):
        flat = jstore._flatten(tree)
        want = jstore._flatten(ref)
        assert set(flat) == set(want)
        for k in want:
            assert flat[k].dtype == np.float32
            np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def _make_sa_dataset(root, n_subj=2):
    for k in ("train", "validation"):
        for i in range(n_subj):
            d = os.path.join(root, k, f"{k}{i}")
            os.makedirs(d, exist_ok=True)
            image, seg = sax_phantom(48, 48, 3, 4, r_lv=8.0, wall=3.0,
                                     rng=np.random.RandomState(i))
            affine = np.diag([1.8, 1.8, 10.0, 1.0])
            for fr, t in (("ED", 0), ("ES", 2)):
                jnifti.save(jnifti.Nifti1Image(image[:, :, :, t], affine),
                            os.path.join(d, f"sa_{fr}.nii.gz"))
                jnifti.save(jnifti.Nifti1Image(
                    seg[:, :, :, t].astype(np.float64), affine),
                    os.path.join(d, f"label_sa_{fr}.nii.gz"))


def test_resume_from_jax_bundle(tmp_path):
    """The JAX trainer writes model-2; the port's trainer resumes from it
    (params, BN state, Adam state, iteration) and writes model-4."""
    _make_sa_dataset(str(tmp_path))
    kw = dict(seq_name="sa", image_size=48, train_batch_size=1,
              num_filter=2, num_level=3, dataset_dir=str(tmp_path),
              checkpoint_dir=str(tmp_path / "ckpt"), validation_every=2,
              checkpoint_every=2)
    jcfg = jsa.SATrainConfig(**kw)
    jsa.train(jcfg, max_iterations=2)
    model_dir = os.path.join(str(tmp_path / "ckpt"), jcfg.model_name)
    ckpt = os.path.join(model_dir, "model-2.npz")
    _, mcfg, names, params, state, _ = jstore.load_model(ckpt)
    net = convert.fcn_from_jax(params, state, names, _port_cfg(mcfg))
    opt = torch.optim.Adam(net.parameters(), lr=LR)
    layout = convert.fcn_layout(names, mcfg)
    convert.load_adam_leaves(opt, net, layout, tstore.load_opt_state(ckpt))
    ref = jax.tree_util.tree_leaves(jstore.load_opt_state(
        ckpt, optax.adam(LR).init(params)))
    for a, b in zip(convert.adam_leaves(opt, net, layout), ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    tcfg = tsa.SATrainConfig(**kw, device="cpu")
    net2, _, _, stats = tsa.train(tcfg, max_iterations=4, resume_from=ckpt)
    assert stats["iterations"] == 2
    assert os.path.exists(os.path.join(model_dir, "model-4.npz"))
    log = [json.loads(l) for l in open(os.path.join(model_dir,
                                                    "train_log.jsonl"))]
    assert [r["iteration"] for r in log] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in log)
    _, _, _, _, _, extra = jstore.load_model(os.path.join(model_dir,
                                                          "model-4.npz"))
    assert extra["iteration"] == 4


def _train_cli(tmp_path, profile, extra=()):
    ckpt = tmp_path / f"ckpt_{profile}"
    argv = ["--dataset_dir", str(tmp_path / "data"), "--profile", profile,
            "--image_size", "48", "--num_filter", "2", "--num_level", "3",
            "--checkpoint_dir", str(ckpt), "--device", "cpu",
            "--train_iteration", "10", *extra]
    return ttrain_cli.main(argv), ckpt


def test_cli_both_profiles_then_deploy(tmp_path):
    """``cli.train_network --device cpu`` in both profiles writes
    train_log.jsonl (validation every 10 iterations) and model-10.npz;
    ``cli.deploy_network --device cpu`` deploys the production bundle;
    the production run resumes from its own bundle."""
    _make_sa_dataset(str(tmp_path / "data"))
    for profile, extra in (
            ("production", ["--batch_slices", "6", "--steps_per_dispatch",
                            "2", "--validation_batch_size", "1",
                            "--pool_gb", "0.01"]),
            ("reference", ["--train_batch_size", "1"])):
        (net, names, mcfg, stats), ckpt = _train_cli(tmp_path, profile,
                                                     extra)
        (model_dir,) = list(ckpt.iterdir())
        log = [json.loads(l) for l in open(model_dir / "train_log.jsonl")]
        assert [r["iteration"] for r in log] == [10]
        assert np.isfinite(log[0]["loss"]) and 0 <= log[0]["val_dice_1"] <= 1
        assert (model_dir / "model-10.npz").exists()
        assert stats["iterations"] == 10
        if profile == "production":
            bundle = model_dir / "model-10.npz"
            assert net.levels[0][0].weight.dtype == torch.float32
    # resume the production run from its own bundle to iteration 12
    (net, _, _, stats), ckpt = _train_cli(
        tmp_path, "production", ["--batch_slices", "6",
                                 "--steps_per_dispatch", "2",
                                 "--pool_gb", "0.01", "--train_iteration",
                                 "12", "--resume_from", str(bundle)])
    assert stats["iterations"] == 2
    subj = tmp_path / "deploy" / "s0"
    write_subject(str(subj), X=48, Y=48, Z=3, T=4,
                  rng=np.random.RandomState(5))
    tdeploy_cli.main(["--seq_name", "sa", "--data_dir",
                      str(tmp_path / "deploy"), "--model_path", str(bundle),
                      "--device", "cpu"])
    seg = np.asarray(jnifti.load(str(subj / "seg_sa.nii.gz")).dataobj)
    assert seg.shape == (48, 48, 3, 4) and seg.max() <= 3


def test_cli_refusals(tmp_path, monkeypatch):
    _make_sa_dataset(str(tmp_path / "data"))
    # a data-parallel batch must divide, as in the JAX trainer; more
    # ranks than cards raise
    with pytest.raises(ValueError, match=r"mesh_devices \(5 % 2 != 0\)"):
        _train_cli(tmp_path, "production", ["--batch_slices", "5",
                                            "--mesh_devices", "2"])
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="has 1"):
            ttrain_cli.main(["--dataset_dir", str(tmp_path / "data"),
                             "--mesh_devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain_cli.main(["--dataset_dir", str(tmp_path / "data"),
                         "--profile", "reference"])
