"""Data-parallel training (``ukbb_cardiac_tpu_torch.train.distributed``,
the DP step builders, global-batch BatchNorm) against the JAX package's
mesh steps, on the CPU.

The JAX side runs its DP steps on a 4-device mesh of the virtual CPU
devices (``tests/conftest.py``); the port runs 4 gloo ranks, each on its
shard of the same global batches (``tests/test_torch_dp_ranks.py`` holds
the rank functions: spawned ranks import it, and it imports no JAX).
Weights go to both through ``ckpt/convert``; the augmentation parameters
of the global batch are injected into both (their generators never
agree).  The ranks spawn once per group of cases.

Tolerances, the single-card trainers' (PERF.md section 2; each
comparison names its own):
- the loss 1e-5 relative, its trajectory over K steps 1e-4 relative;
  aux metrics (ratios of the global batch's counts) 1e-6;
- gradients 1e-4 of each tensor's largest (train-mode BatchNorm scales
  of the aortic U-Net 5e-4, ``tests/test_torch_ao_train.py``); new BN
  state 1e-6;
- parameters after one Adam step: 1e-5 of lr, plus 1e-6 relative (one
  float32 ulp at 1); after K steps K x 1e-3 of lr: Adam's normalised
  step m / sqrt(v) amplifies the gradients' 1e-4 differences where two
  steps' gradients nearly cancel (the worst seen, 9.5e-4 of lr, one
  weight of 576 after 2 steps); the Adam moments 1e-4 (first) and 2e-4
  (second) of each tensor's largest, as the gradients they hold;
- the port's ranks against the port's single process at the same global
  batch and seed: 1e-5 of each tensor's largest (the float sums run in
  another order); one rank against the single process: bitwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import test_torch_dp_ranks as ranks
from ukbb_cardiac_tpu import ops as jops
from ukbb_cardiac_tpu.models import fcn as jfcn
from ukbb_cardiac_tpu.models import unet as junet
from ukbb_cardiac_tpu.ops import augment as jaug
from ukbb_cardiac_tpu.ops import resample as jres
from ukbb_cardiac_tpu.train import ao as jao
from ukbb_cardiac_tpu.train import device_pool as jpool
from ukbb_cardiac_tpu.train import sa as jsa
from ukbb_cardiac_tpu.train import steps as jsteps
from ukbb_cardiac_tpu_torch.ckpt import convert
from ukbb_cardiac_tpu_torch.models import fcn as tfcn
from ukbb_cardiac_tpu_torch.models import layers as tL
from ukbb_cardiac_tpu_torch.models import unet as tunet
from ukbb_cardiac_tpu_torch.models import wrappers as twrappers
from ukbb_cardiac_tpu_torch.train import ao as tao
from ukbb_cardiac_tpu_torch.train import distributed
from ukbb_cardiac_tpu_torch.train import sa as tsa

torch.set_num_threads(1)

WORLD = 4
LR = 1e-3
GAMMA_RTOL = 5e-4
NARROW = jfcn.FCNConfig(n_class=4, n_level=3, n_filter=(4, 8, 8),
                        n_block=(2, 1, 2), same_dim=4, fc=8)
PORT_NARROW = tfcn.FCNConfig(**dataclasses.asdict(NARROW))
B, SIZE = 8, 32


# ------------------------------------------------------------ the cases

def _fcn_weights(seed=0):
    """JAX init with non-trivial BN parameters and statistics."""
    params, state, names = jfcn.init_fcn(jax.random.PRNGKey(seed), NARROW)
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


def _aug_params(n, seed):
    rng = np.random.RandomState(seed)
    return {"shift": rng.randn(n, 2).astype(np.float32) * 2,
            "rotate": rng.randn(n).astype(np.float32) * 10,
            "scale": (1 + rng.randn(n) * 0.2).astype(np.float32),
            "intensity": np.ones(n, np.float32),
            "flip_x": rng.rand(n) >= 0.5}


def _jax_injected(p):
    """``ops.data_augmenter_jax`` with the global batch's drawn parameters
    (one transform per slice, no flip: the trainers' settings)."""
    def augment(key, image, label, shift, rotate, scale, intensity, flip,
                sample_dtype=None):
        def one(im, la, sh, ro, sc):
            m, o = jaug._affine_from_params(im.shape[0], im.shape[1], sh,
                                            ro, sc)
            im = jax.vmap(lambda ch: jres.affine_transform_2d(
                ch, m, o, order=1), in_axes=2, out_axes=2)(
                im.astype(jnp.float32))
            la = jres.affine_transform_2d(la.astype(jnp.float32), m, o,
                                          order=0).astype(jnp.int32)
            return im, la

        return jax.vmap(one)(image, label, jnp.asarray(p["shift"]),
                             jnp.asarray(p["rotate"]),
                             jnp.asarray(p["scale"]))

    return augment


def _sa_batches(K, seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(K, B, SIZE, SIZE, 1).astype(np.float32),
            "label": rng.randint(0, 4, (K, B, SIZE, SIZE)).astype(np.int32)}


def _pool(n_slots, t_max, seed, n_class=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(n_slots, t_max, SIZE, SIZE).astype(np.float16),
            rng.randint(0, n_class, (n_slots, t_max, SIZE, SIZE)).astype(
                np.uint8))


def _ao_cfg(model):
    return jao.AoTrainConfig(model=model, num_filter=2, num_level=3,
                             num_hidden=3, weight_R=2, weight_r=0.5,
                             image_size=SIZE, learning_rate=LR)


def _ao_pcfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    return tao.AoTrainConfig(**{**fields, "device": "cpu"})


def _ao_weights(model, seed):
    """(ucfg, params, state, names) of a random aortic model with random
    BN parameters and statistics, written out in the JAX layout."""
    ucfg, net, names = tao.init_ao_model(
        _ao_pcfg(_ao_cfg(model)), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if k.endswith(("gamma", "moving_variance")):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
            elif k.endswith(("beta", "moving_mean")):
                v.copy_(torch.randn(v.shape, generator=g) * 0.1)
    params, state = tao.bundle_trees(net, names)
    return junet.UNetConfig(**dataclasses.asdict(ucfg)), params, state, names


def _ao_port_net(model, ucfg, params, state, names):
    unet = convert.unet_from_jax(params, state, names,
                                 tunet.UNetConfig(**dataclasses.asdict(ucfg)))
    if model != "UNet-LSTM":
        return unet
    return twrappers.UNetLSTM(unet, convert.convlstm_from_jax(params, True))


def _ao_layout(net, names):
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


CASES = ("fcn_step", "fcn_multi", "fcn_pool_slice", "unet_step",
         "lstm_pool_window")


def _case(name):
    """(port case for ``ranks.run_case``, JAX setup) of one case."""
    if name.startswith("fcn"):
        params, state, names = _fcn_weights()
        K = {"fcn_step": 1, "fcn_multi": 3, "fcn_pool_slice": 2}[name]
        inject = _aug_params(B, 7)
        make_loss = functools.partial(tsa.make_fcn_loss, cfg=PORT_NARROW,
                                      device_augment=True)
        jloss = jsa.make_fcn_loss(names, NARROW, device_augment=True)
        jopt = optax.adam(LR)
        layout = convert.fcn_layout(names, NARROW)
        net = convert.fcn_from_jax(params, state, names, PORT_NARROW)
        model = "fcn"
    else:
        model = "UNet" if name == "unet_step" else "UNet-LSTM"
        jcfg = _ao_cfg(model)
        ucfg, params, state, names = _ao_weights(model, 1 + len(name))
        K = 1 if name == "unet_step" else 2
        inject = None
        make_loss = functools.partial(tao.make_ao_loss, _ao_pcfg(jcfg))
        jloss = jao.make_ao_loss(jcfg, ucfg, names)
        jopt = jao.make_ao_optimizer(jcfg, params)
        net = _ao_port_net(model, ucfg, params, state, names)
        layout = _ao_layout(net, names)
    case = dict(net=net, make_loss=make_loss, seeds=list(range(1, K + 1)),
                inject=inject, builder="single" if K == 1 else "multi")
    if name == "lstm_pool_window":
        case["make_optimizer"] = functools.partial(tao.make_ao_optimizer,
                                                   _ao_pcfg(jcfg))
    if name == "fcn_pool_slice":
        pool = _pool(3, 4, 5)
        rng = np.random.RandomState(6)
        case["batches"] = {"slot": rng.randint(0, 3, (K, B)).astype(np.int32),
                           "zidx": rng.randint(0, 4, (K, B)).astype(np.int32)}
        case.update(builder="pool_slice", pool=pool)
    elif name == "lstm_pool_window":
        tw = jcfg.time_window
        pool = _pool(3, 6, 8, n_class=3)
        rng = np.random.RandomState(9)
        start = rng.randint(0, 6, (K, 4, 1))
        tidx = ((start + np.arange(tw)) % 6).astype(np.int32)
        case["batches"] = {"slot": rng.randint(0, 3, (K, 4)).astype(np.int32),
                           "tidx": tidx, "lidx": tidx[..., ::-1].copy()}
        case.update(builder="pool_window", pool=pool)
    elif name == "unet_step":
        rng = np.random.RandomState(10)
        case["batches"] = {
            "image": rng.rand(K, 4, SIZE, SIZE, 1).astype(np.float32),
            "label": rng.randint(0, 3, (K, 4, SIZE, SIZE)).astype(np.int32)}
    else:
        case["batches"] = _sa_batches(K, 11)
    return case, dict(params=params, state=state, names=names, loss=jloss,
                      opt=jopt, layout=layout, model=model)


def _jax_run(case, js, mesh):
    """The JAX package's DP step(s) on the mesh: the same global batches,
    the injected augmentation.  Returns (losses, last aux, new params,
    new state, opt state, and for one step its gradients)."""
    repl = NamedSharding(mesh, P())
    params = jax.tree_util.tree_map(jnp.asarray, js["params"])
    state, opt = js["state"], js["opt"]
    opt_state = opt.init(params)
    K = len(case["seeds"])
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(1, K + 1))
    with pytest.MonkeyPatch.context() as mp:
        if case["inject"] is not None:
            mp.setattr(jops, "data_augmenter_jax",
                       _jax_injected(case["inject"]))
        batches = {k: jnp.asarray(v) for k, v in case["batches"].items()}
        if case["builder"].startswith("pool"):
            make = (jpool.make_pool_slice_multi_dp_step
                    if case["builder"] == "pool_slice"
                    else jpool.make_pool_window_multi_dp_step)
            img, lab = (jax.device_put(jnp.asarray(a), repl)
                        for a in case["pool"])
            out = make(js["loss"], opt, mesh)(params, state, opt_state, img,
                                              lab, batches, keys)
            return out[3], out[4], out[0], out[1], out[2], None
        first = {k: v[0] for k, v in batches.items()}
        if K == 1:
            shard = NamedSharding(mesh, P("data"))
            grad_fn = jax.jit(jax.value_and_grad(js["loss"], has_aux=True),
                              in_shardings=(repl, repl, shard, repl))
            (_, _), grads = grad_fn(params, state, first, keys[0])
            step = jsteps.make_dp_train_step(js["loss"], opt, mesh,
                                             donate=False)
            p, s, o, loss, aux = step(params, state, opt_state, first,
                                      keys[0])
            return loss[None], aux, p, s, o, grads
        step = jsteps.make_multi_dp_train_step(js["loss"], opt, mesh,
                                               donate=False)
        p, s, o, losses, aux = step(params, state, opt_state, batches, keys)
        return losses, aux, p, s, o, None


def _seeded_cases():
    """Cases with the device augmenters' own draws (nothing injected):
    the ranks draw the global batch's parameters from the step's seed and
    keep their rows, so they equal one process's draws.  An FCN, and a
    jointly trained UNet-LSTM from its window pool."""
    params, state, names = _fcn_weights(3)
    fcn = dict(net=convert.fcn_from_jax(params, state, names, PORT_NARROW),
               make_loss=functools.partial(
                   tsa.make_fcn_loss, cfg=PORT_NARROW, device_augment=True,
                   rotate=30.0, scale=0.2, shift=2.0),
               batches=_sa_batches(2, 12), seeds=[5, 6], builder="multi")
    jcfg = dataclasses.replace(_ao_cfg("UNet-LSTM"), joint_train=True)
    ucfg, params, state, names = _ao_weights("UNet-LSTM", 4)
    pool = _pool(3, 6, 13, n_class=3)
    rng = np.random.RandomState(14)
    tidx = ((rng.randint(0, 6, (2, 4, 1)) + np.arange(jcfg.time_window))
            % 6).astype(np.int32)
    lstm = dict(net=_ao_port_net("UNet-LSTM", ucfg, params, state, names),
                make_loss=functools.partial(tao.make_ao_loss,
                                            _ao_pcfg(jcfg),
                                            device_augment=True),
                batches={"slot": rng.randint(0, 3, (2, 4)).astype(np.int32),
                         "tidx": tidx, "lidx": tidx},
                seeds=[3, 4], builder="pool_window", pool=pool)
    return {"fcn_seeded": fcn, "lstm_seeded": lstm}


@pytest.fixture(scope="module")
def jax_setups():
    """(port case, JAX setup) of each JAX-parity case."""
    return {name: _case(name) for name in CASES}


@pytest.fixture(scope="module")
def cases(jax_setups):
    """Every port case by name: the JAX-parity ones and the seeded ones."""
    return {**{n: c for n, (c, _) in jax_setups.items()}, **_seeded_cases()}


@pytest.fixture(scope="module")
def four_ranks(cases):
    """Every case's result in rank 0 of one 4-rank gloo group."""
    out = distributed.run(ranks.run_cases, (list(cases.values()),),
                          ["cpu"] * WORLD)
    return dict(zip(cases, out))


@pytest.fixture(scope="module")
def single(cases):
    """Every case in this process: the single-process yardstick."""
    return {n: ranks.run_case(None, c) for n, c in cases.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --------------------------------------------------------- against JAX

@pytest.mark.parametrize("name", CASES)
def test_dp_steps_match_jax_mesh(name, jax_setups, four_ranks,
                                 eight_devices):
    """Loss, aux, gradients, new BN state, parameters and Adam state of
    4 gloo ranks against the JAX DP step on a 4-device mesh."""
    case, js = jax_setups[name]
    mesh = Mesh(np.array(eight_devices[:WORLD]), ("data",))
    jlosses, jaux, jp, jstate, jopt, jgrads = _jax_run(case, js, mesh)
    got = four_ranks[name]
    K = len(case["seeds"])
    np.testing.assert_allclose(got["losses"].numpy(), np.asarray(jlosses),
                               rtol=1e-5 if K == 1 else 1e-4)
    assert set(got["aux"]) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(got["aux"][k]), float(jaux[k]),
                                   atol=1e-6, err_msg=k)
    sd = {**got["state"]}
    frozen = js["model"] == "UNet-LSTM"
    n_params = 0
    for key, tree, path in js["layout"]:
        if tree == "state":
            np.testing.assert_allclose(
                convert.to_jax(sd[key], path), _get(jstate, path),
                atol=1e-6, rtol=0, err_msg=key)
            continue
        want = _get(jp, path)
        np.testing.assert_allclose(
            convert.to_jax(sd[key], path), want, err_msg=key,
            rtol=1e-6, atol=(1e-5 if K == 1 else K * 1e-3) * LR)
        if frozen and key.startswith("unet."):
            np.testing.assert_array_equal(convert.to_jax(sd[key], path),
                                          _get(js["params"], path))
        if jgrads is not None and key in got["grads"]:
            rtol = GAMMA_RTOL if (path[-1] == "gamma"
                                  and js["model"] != "fcn") else 1e-4
            ref = _get(jgrads, path)
            np.testing.assert_allclose(
                convert.to_jax(got["grads"][key], path), ref, rtol=0,
                atol=rtol * np.abs(ref).max(), err_msg=key)
            n_params += 1
    if jgrads is not None:
        assert n_params == len(got["grads"]) > 0
    if js["model"] == "fcn":
        # Adam's moments against optax's leaves (count, mu, nu)
        net = convert.fcn_from_jax(js["params"], js["state"], js["names"],
                                   PORT_NARROW)
        net.load_state_dict(got["state"])
        opt = torch.optim.Adam(net.parameters(), lr=LR)
        opt.load_state_dict(got["adam"])
        leaves = convert.adam_leaves(opt, net, js["layout"])
        ref = jax.tree_util.tree_leaves(jopt)
        assert int(leaves[0]) == int(ref[0]) == K
        half = (len(ref) - 1) // 2
        for i, (a, b) in enumerate(zip(leaves[1:], ref[1:])):
            b = np.asarray(b)
            tol = 1e-4 if i < half else 2e-4
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=tol * np.abs(b).max() + 1e-20)


# ---------------------------------------- against the port's one process

@pytest.mark.parametrize("name", CASES + ("fcn_seeded", "lstm_seeded"))
def test_four_ranks_match_single_process(name, four_ranks, single):
    """4 ranks against the single process on the same global batches and
    seeds: losses, aux, gradients and every parameter and statistic.  The
    seeded cases draw their augmentation from the generator: the ranks
    draw the global batch's parameters and keep their rows."""
    got, want = four_ranks[name], single[name]
    np.testing.assert_allclose(got["losses"].numpy(),
                               want["losses"].numpy(), rtol=1e-5)
    for k, v in want["aux"].items():
        np.testing.assert_allclose(float(got["aux"][k]), float(v),
                                   atol=1e-6, err_msg=k)
    assert set(got["grads"]) == set(want["grads"])
    for k, v in want["grads"].items():
        assert _rel(got["grads"][k], v) <= 1e-4, k
    for k, v in want["state"].items():
        assert _rel(got["state"][k], v) <= 1e-5, k


def test_seeded_cases_augment(cases, single):
    """The seeded cases' augmentation moves pixels: without it their
    losses differ."""
    for name in ("fcn_seeded", "lstm_seeded"):
        case = cases[name]
        plain = ranks.run_case(None, {**case, "make_loss": functools.partial(
            case["make_loss"], device_augment=False)})
        assert not torch.equal(plain["losses"], single[name]["losses"])


def test_two_ranks_match_single_process(cases, single):
    """2 gloo ranks against the single process on the seeded cases: the
    same global batches and seeds, the augmenters' own draws."""
    names = ("fcn_seeded", "lstm_seeded")
    got = distributed.run(ranks.run_cases, ([cases[n] for n in names],),
                          ["cpu"] * 2)
    for g, name in zip(got, names):
        want = single[name]
        np.testing.assert_allclose(g["losses"].numpy(),
                                   want["losses"].numpy(), rtol=1e-5)
        for k, v in want["aux"].items():
            np.testing.assert_allclose(float(g["aux"][k]), float(v),
                                       atol=1e-6, err_msg=k)
        for k, v in want["grads"].items():
            assert _rel(g["grads"][k], v) <= 1e-4, k
        for k, v in want["state"].items():
            assert _rel(g["state"][k], v) <= 1e-5, k


def test_one_rank_is_bitwise_the_single_process(cases, single):
    """A world of one runs the DP builders (the all-reduce, the division
    by one) and equals the single-card step bit for bit: the FCN's K
    steps and the window pool's, with the augmenters' own draws."""
    names = ("fcn_seeded", "lstm_seeded")
    got = distributed.run(ranks.run_cases, ([cases[n] for n in names],),
                          ["cpu"])
    for g, name in zip(got, names):
        want = single[name]
        assert torch.equal(g["losses"], want["losses"])
        for k, v in want["state"].items():
            assert torch.equal(g["state"][k], v), k
        for k, v in want["grads"].items():
            assert torch.equal(g["grads"][k], v), k
        for i, st in want["adam"]["state"].items():
            for k, v in st.items():
                assert torch.equal(g["adam"]["state"][i][k], v), (i, k)


# ------------------------------------------------------- global BatchNorm

def test_batch_norm_without_group_is_unchanged():
    """No group and a None group take the single-card path: the batch's
    own statistics, bit for bit; ``batch_norm_group`` restores the
    groups it set."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 3, 5, 6).astype(np.float32))
    gamma, beta = torch.rand(3) + 0.5, torch.randn(3)
    outs = []
    for group in (None, "absent"):
        mm, mv = torch.zeros(3), torch.ones(3)
        kw = {} if group == "absent" else {"group": None}
        outs.append((tL.batch_norm(x, gamma, beta, mm, mv, True, **kw),
                     mm, mv))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    net = tfcn.FCN(PORT_NARROW)
    with tL.batch_norm_group(net, "g"):
        assert all(m.bn_group == "g" for m in tL._batch_norms(net))
    assert all(m.bn_group is None for m in tL._batch_norms(net))
