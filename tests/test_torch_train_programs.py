"""The trainers' step programs (``train/steps.py``: the port's Adam, the
K-step calls with the augmentation drawn before the call, the pool steps
over the pool by address, the validation programs) against the JAX
package, on the CPU, at small widths.

On the CPU a program runs its function directly, so these tests reach
the code that the card captures; ``tests/test_torch_card.py`` holds the
graphs against the eager route there.

Tolerances (each test states its own):
- the port's Adam against ``optax.adam`` (with and without
  ``piecewise_constant_schedule``), the same gradients: parameters within
  1e-5 of lr (plus 1e-6 relative) after every update, the moments 1e-6
  of each tensor's largest, the count equal;
- K steps of the FCN and aortic steps against the JAX package's
  ``make_multi_train_step`` and pool steps, the augmentation's parameters
  injected into both (their generators never agree), with the bounds of
  ``tests/test_torch_train.py``: every step's loss 1e-4 relative (1e-5
  for one step), aux 1e-6, BN state 1e-6, a frozen U-Net bitwise, and
  after one step the parameters 1e-5 of lr plus 1e-6 relative.  After K
  > 1 steps the parameters are not held to JAX's: Adam's normalised step
  turns the gradients' float32 differences into moves of up to lr where
  a gradient nearly cancels (the FCN case's worst weight differs by
  0.023 of lr after 3 steps, through ``torch.optim.Adam`` as through the
  port's); the later steps' losses carry the updated parameters;
- draws made before the call against draws made inside the loss, the
  device head packing against the host's, a port bundle read back:
  bitwise.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_dp as dpt
import test_torch_dp_ranks as ranks
from test_torch_train import _make_sa_dataset, _port_cfg
from ukbb_cardiac_tpu import ops as jops
from ukbb_cardiac_tpu.ckpt import store as jstore
from ukbb_cardiac_tpu.train import device_pool as jpool
from ukbb_cardiac_tpu.train import sa as jsa
from ukbb_cardiac_tpu.train import steps as jsteps
from ukbb_cardiac_tpu_torch.ckpt import convert
from ukbb_cardiac_tpu_torch.ckpt import store as tstore
from ukbb_cardiac_tpu_torch.models import fcn as tfcn
from ukbb_cardiac_tpu_torch.models import fused_head as tfh
from ukbb_cardiac_tpu_torch.reg import programs
from ukbb_cardiac_tpu_torch.train import ao as tao
from ukbb_cardiac_tpu_torch.train import distributed
from ukbb_cardiac_tpu_torch.train import sa as tsa
from ukbb_cardiac_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

LR = 1e-3


# ------------------------------------------------------------------ Adam

@pytest.mark.parametrize("boundaries", [(), (2, 4)])
def test_adam_matches_optax(boundaries):
    """The port's Adam (its state on the parameters' device, the step
    count and learning rate device tensors) against ``optax.adam`` and
    the JAX trainers' ``adam_with_schedule``: six updates of the same
    gradients into a channels-last kernel and a vector."""
    rng = np.random.RandomState(3)
    shapes = [(8, 4, 3, 3), (8,)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    w = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    w[0] = torch.nn.Parameter(w[0].detach().to(
        memory_format=torch.channels_last))
    opt = tsteps.adam_with_schedule(w, LR, reduce_after=list(boundaries),
                                    reduce_factor=0.1)
    assert type(opt) is (tsteps.ScheduledAdam if boundaries else tsteps.Adam)
    jopt = jsteps.adam_with_schedule(LR, reduce_after=list(boundaries))
    jw = [jnp.asarray(a) for a in init]
    js = jopt.init(jw)
    for i in range(6):
        grads = [rng.randn(*s).astype(np.float32) * 10 ** (i % 3 - 3)
                 for s in shapes]
        for p, g in zip(w, grads):
            p.grad = torch.from_numpy(g.copy()).to(
                memory_format=torch.preserve_format)
        opt.step()
        upd, js = jopt.update([jnp.asarray(g) for g in grads], js, jw)
        jw = optax.apply_updates(jw, upd)
        for p, q in zip(w, jw):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       rtol=1e-6, atol=1e-5 * LR)
    ref = jax.tree_util.tree_leaves(js)
    for p in w:
        assert opt.state[p]["step"].device == p.device
        assert opt.state[p]["exp_avg"].stride() == p.stride()
    assert int(opt.state[w[0]]["step"]) == int(ref[0]) == 6
    got = ([opt.state[p]["exp_avg"] for p in w]
           + [opt.state[p]["exp_avg_sq"] for p in w])
    for a, b in zip(got, ref[1:]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


# ------------------------------------------------- K steps against JAX

def _jax_single(case, js):
    """The JAX package's single-device K-step call (``lax.scan``) or pool
    step on the case's batches, the injected augmentation."""
    params = jax.tree_util.tree_map(jnp.asarray, js["params"])
    opt = js["opt"]
    K = len(case["seeds"])
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(1, K + 1))
    with pytest.MonkeyPatch.context() as mp:
        if case["inject"] is not None:
            mp.setattr(jops, "data_augmenter_jax",
                       dpt._jax_injected(case["inject"]))
        batches = {k: jnp.asarray(v) for k, v in case["batches"].items()}
        if case["builder"].startswith("pool"):
            make = (jpool.make_pool_slice_multi_step
                    if case["builder"] == "pool_slice"
                    else jpool.make_pool_window_multi_step)
            img, lab = (jnp.asarray(a) for a in case["pool"])
            p, s, _, losses, aux = make(js["loss"], opt)(
                params, js["state"], opt.init(params), img, lab, batches,
                keys)
        else:
            p, s, _, losses, aux = jsteps.make_multi_train_step(
                js["loss"], opt)(params, js["state"], opt.init(params),
                                 batches, keys)
    return losses, aux, p, s


@pytest.mark.parametrize("name", ["fcn_step", "fcn_multi", "fcn_pool_slice",
                                  "unet_step", "lstm_pool_window"])
def test_k_steps_match_jax(name):
    """One call of the port's K-step builder (``multi``: the FCN's K = 1
    and K = 3 on host batches; ``pool_slice``: K = 2 gathered from the
    slice pool;
    the U-Net's one step; the phase-2 UNet-LSTM's K = 2 from the window
    pool, the U-Net frozen) against the JAX package's single-device step
    on the same batches, the FCN's augmentation drawn before the call
    (injected into both)."""
    case, js = dpt._case(name)
    case = {**case, "builder": "multi" if case["builder"] == "single"
            else case["builder"]}
    got = ranks.run_case(None, case)
    jlosses, jaux, jp, jstate = _jax_single(case, js)
    K = len(case["seeds"])
    np.testing.assert_allclose(got["losses"].numpy(), np.asarray(jlosses),
                               rtol=1e-5 if K == 1 else 1e-4)
    for k in jaux:
        np.testing.assert_allclose(float(got["aux"][k]),
                                   float(np.asarray(jaux[k])), atol=1e-6,
                                   err_msg=k)
    frozen = js["model"] == "UNet-LSTM"
    for key, tree, path in js["layout"]:
        have = convert.to_jax(got["state"][key], path)
        if tree == "state":
            np.testing.assert_allclose(have, dpt._get(jstate, path),
                                       atol=1e-6, rtol=0, err_msg=key)
            continue
        if K == 1:
            np.testing.assert_allclose(have, dpt._get(jp, path), rtol=1e-6,
                                       atol=1e-5 * LR, err_msg=key)
        if frozen and key.startswith("unet."):
            np.testing.assert_array_equal(have, dpt._get(js["params"], path))


@pytest.mark.parametrize("model", ["fcn", "UNet-LSTM"])
def test_draws_before_the_call_are_the_losses_own(model):
    """The builders draw every step's augmentation before the call
    (``loss_fn.draw``) from the generator and seed the loss itself would
    use: two K-step calls equal the same steps through a loss that draws
    inside itself (no ``draw``), bitwise -- the FCN's K = 2 on host
    batches, the jointly trained UNet-LSTM's from the window pool."""
    cases = dpt._seeded_cases()
    case = cases["fcn_seeded" if model == "fcn" else "lstm_seeded"]
    make_loss = case["make_loss"]

    def inside(net, group=None):
        loss_fn = make_loss(net, group=group)
        return lambda batch, seed: loss_fn(batch, seed)

    before = distributed.replica_steps(None, **case, calls=2)
    within = distributed.replica_steps(
        None, **{**case, "make_loss": inside}, calls=2)
    assert torch.equal(before["losses"], within["losses"])
    for k, v in before["state"].items():
        assert torch.equal(v, within["state"][k]), k
    assert before["route"] == "single"


# ----------------------------------------------------- the head packing

@pytest.mark.parametrize("n_class", [2, 3, 4, 6])
def test_device_head_packing_is_bitwise_the_hosts(n_class):
    """``HeadWeights.pack_on_device`` (torch ops, int32 bit operations
    for the TF32 split, views for the fragment order) against the host
    packing ``HeadWeights.packed`` of the same folded weights, at the
    kernel's widths, bit for bit."""
    cfg = tfcn.FCNConfig(n_class=n_class, n_level=3, n_filter=(16, 32, 64),
                         n_block=(2, 2, 3))
    net = tfcn.init_weights(tfcn.FCN(cfg), torch.Generator().manual_seed(
        n_class))
    g = torch.Generator().manual_seed(10 + n_class)
    with torch.no_grad():
        for name, t in net.named_buffers():
            t.copy_(torch.rand(t.shape, generator=g) + 0.5
                    if name.endswith("variance")
                    else torch.randn(t.shape, generator=g) * 0.1)
    host = tfh.fold_head(net).packed("cpu")
    here = tfh.fold_head(net).pack_on_device()
    assert host.shape == here.shape and here.dtype == torch.float32
    assert torch.equal(host.view(torch.int32), here.view(torch.int32))


# ------------------------------------------- no host sync inside a call

class _NoHostData(TorchDispatchMode):
    """Fails on what a CUDA graph capture cannot hold: a read back to the
    host (``aten._local_scalar_dense``: ``.item()``, ``float()``,
    ``bool()``) and a tensor made from host data (``torch.tensor``, or any
    argument whose storage neither existed before the block nor came out
    of an operation inside it: ``torch.from_numpy``)."""

    BANNED = {"aten::_local_scalar_dense", "aten::lift_fresh",
              "aten::lift_fresh_copy", "aten::lift"}

    def __init__(self):
        super().__init__()
        gc.collect()
        self.known = {o.untyped_storage().data_ptr()
                      for o in gc.get_objects() if torch.is_tensor(o)}
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in self.BANNED:
            raise AssertionError(f"{name} inside a step call")
        for t in torch.utils._pytree.tree_leaves((args, kwargs)):
            if (torch.is_tensor(t) and t.numel()
                    and t.untyped_storage().data_ptr() not in self.known):
                raise AssertionError(f"{name} reads a tensor made from "
                                     f"host data: {tuple(t.shape)}")
        out = func(*args, **kwargs)
        for t in torch.utils._pytree.tree_leaves(out):
            if torch.is_tensor(t):
                self.known.add(t.untyped_storage().data_ptr())
        self.ops += 1
        return out


class _SentinelPrograms:
    """A program cache for the test: the first call of a tag runs as it
    is (on the card the eager warm-up, which fills the caches), later
    ones under :class:`_NoHostData` (on the card the capture)."""

    def __init__(self):
        self.seen, self.guarded = set(), []

    def run(self, tag, fn, *inputs, out=None):
        if tag not in self.seen:
            self.seen.add(tag)
            return fn(*inputs)
        with _NoHostData() as mode:
            result = fn(*inputs)
        self.guarded.append((tag[0], mode.ops))
        return result

    def clear(self):
        pass


def _sentinel_cases():
    cases = dpt._seeded_cases()
    fcn = dict(cases["fcn_seeded"], make_loss=lambda net, group=None:
               tsa.make_fcn_loss(net, dpt.PORT_NARROW, device_augment=True,
                                 compute_dtype=torch.bfloat16, group=group))
    return {"fcn_multi_bf16": fcn, "lstm_pool_window": cases["lstm_seeded"]}


@pytest.mark.parametrize("name", ["fcn_multi_bf16", "lstm_pool_window"])
def test_step_call_reads_nothing_back_and_uploads_nothing(name):
    """The body of a K-step call (the augmentation's warp, the forward,
    the backward, the gradients zeroed in place, the port's Adam; for the
    UNet-LSTM the pool gather and the ConvLSTM's scan) under a dispatch
    mode that fails on a read back to the host and on a tensor made from
    host data: the syncs and uploads a CUDA graph capture refuses,
    caught on the CPU."""
    case = _sentinel_cases()[name]
    sentinel = _SentinelPrograms()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(programs, "ProgramCache", lambda **kw: sentinel)
        distributed.replica_steps(None, **case, calls=2)
    assert len(sentinel.guarded) == 1 and sentinel.guarded[0][1] > 100


def test_validation_programs_read_nothing_back():
    """The SA validation forward (fold, encoder, plain head, argmax) and
    the aortic validation loss under the same dispatch mode."""
    params, state, names = dpt._fcn_weights()
    net = convert.fcn_from_jax(params, state, names, dpt.PORT_NARROW)
    sentinel = _SentinelPrograms()
    images = np.random.RandomState(0).rand(3, 32, 32, 1).astype(np.float32)
    for _ in range(2):
        tsa.validation_predict(net, images, "cpu", sentinel)
    jcfg = dpt._ao_cfg("UNet-LSTM")
    ucfg, params, state, names = dpt._ao_weights("UNet-LSTM", 2)
    ao = dpt._ao_port_net("UNet-LSTM", ucfg, params, state, names)
    eval_loss = tao.make_ao_loss(dpt._ao_pcfg(jcfg), ao, train=False)
    step = tsteps.make_eval_step(lambda b: eval_loss(b, 0),
                                 programs=sentinel)
    rng = np.random.RandomState(1)
    tw = jcfg.time_window
    batch = {"image": torch.from_numpy(
                 rng.rand(2, tw, 32, 32, 1).astype(np.float32)),
             "label": torch.from_numpy(
                 rng.randint(0, 3, (2, tw, 32, 32)).astype(np.int32))}
    first, second = step(batch), step(batch)
    assert torch.equal(first[0], second[0])
    assert [t for t, _ in sentinel.guarded] == ["sa_validation", "eval"]


def test_caches_made_in_inference_mode_serve_a_backward():
    """The upsampling matrices and the window weights that a step reads
    from per-device caches: made first under ``torch.inference_mode``
    (a deploy's forward), they still serve a training forward whose
    backward saves them (an inference tensor would raise there)."""
    from ukbb_cardiac_tpu_torch.models import layers as tL
    from ukbb_cardiac_tpu_torch.models import losses as tlosses

    x = torch.rand(2, 3, 13, 11)
    logits = torch.randn(2, 17, 4, 4, 3)
    labels = torch.randint(0, 3, (2, 17, 4, 4))
    with torch.inference_mode():
        want = tL.transpose_upsample2d(x, 4)
        tlosses.weighted_temporal_cross_entropy(logits, labels, 3, 7, 1.5)
    x.requires_grad_(True)
    logits.requires_grad_(True)
    got = tL.transpose_upsample2d(x, 4)
    loss = (got.sum()
            + tlosses.weighted_temporal_cross_entropy(logits, labels, 3, 7,
                                                      1.5))
    loss.backward()
    assert torch.equal(got.detach(), want)
    assert x.grad is not None and logits.grad is not None


# ------------------------------------------------------------- routes

def test_routes_are_chosen_when_the_step_is_built(tmp_path):
    """One device: "single"; a gloo group: uncaptured, by design (gloo
    stages CUDA tensors through the host), fixed when the step is built;
    on the CPU no program is ever captured."""
    import torch.distributed as dist

    w = torch.nn.Parameter(torch.zeros(3))
    opt = tsteps.Adam([w], LR)

    def loss_fn(batch, seed):
        return (w * batch["x"]).sum() ** 2, {}

    single = tsteps.make_train_step(loss_fn, opt)
    assert single.route == "single"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        dp = tsteps.make_multi_dp_train_step(loss_fn, opt, dist.group.WORLD)
        assert dp.route == "gloo group (uncaptured)"
        dp({"x": torch.ones(2, 3)}, [1, 2])
    finally:
        dist.destroy_process_group()
    single({"x": torch.ones(3)}, 3)
    assert int(opt.state[w]["step"]) == 3
    assert dp.programs.programs() == single.programs.programs() == []


# --------------------------------------------------------- checkpoints

def test_port_bundle_after_k_steps_resumes_and_reads_in_jax(tmp_path):
    """The port's trainer (K = 2 steps a call, batch_slices, the port's
    Adam) writes model-2; the JAX package reads its Adam state (count 2,
    the moments equal to the port's); the port resumes from it with the
    Adam state on the parameters' device and writes model-4, whose count
    the JAX package reads as 4."""
    _make_sa_dataset(str(tmp_path))
    kw = dict(seq_name="sa", image_size=48, train_batch_size=1,
              num_filter=2, num_level=3, dataset_dir=str(tmp_path),
              checkpoint_dir=str(tmp_path / "ckpt"), validation_every=2,
              checkpoint_every=2, batch_slices=4, steps_per_dispatch=2)
    cfg = tsa.SATrainConfig(**kw, device="cpu")
    tsa.train(cfg, max_iterations=2)
    model_dir = tmp_path / "ckpt" / cfg.model_name
    ckpt = str(model_dir / "model-2.npz")
    _, mcfg, names, params, state, _ = jstore.load_model(ckpt)
    ref = jax.tree_util.tree_leaves(jstore.load_opt_state(
        ckpt, optax.adam(LR).init(params)))
    net = convert.fcn_from_jax(params, state, names, _port_cfg(mcfg))
    opt = tsteps.Adam(net.parameters(), lr=LR)
    layout = convert.fcn_layout(names, mcfg)
    convert.load_adam_leaves(opt, net, layout, tstore.load_opt_state(ckpt))
    assert all(st["step"].device == p.device and int(st["step"]) == 2
               for p, st in opt.state.items())
    leaves = convert.adam_leaves(opt, net, layout)
    assert len(leaves) == len(ref) and int(ref[0]) == 2
    for a, b in zip(leaves, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    _, _, _, stats = tsa.train(cfg, max_iterations=4, resume_from=ckpt)
    assert stats["iterations"] == 2
    ref4 = jax.tree_util.tree_leaves(jstore.load_opt_state(
        str(model_dir / "model-4.npz"), optax.adam(LR).init(params)))
    assert int(ref4[0]) == 4
    assert not np.array_equal(np.asarray(ref4[1]), np.asarray(ref[1]))


def test_jax_trainer_resumes_from_the_ports_bundle(tmp_path):
    """The JAX trainer resumes from the port's K-step bundle (its params,
    BN state and Adam state) and continues to iteration 4."""
    _make_sa_dataset(str(tmp_path))
    kw = dict(seq_name="sa", image_size=48, train_batch_size=1,
              num_filter=2, num_level=3, dataset_dir=str(tmp_path),
              checkpoint_dir=str(tmp_path / "ckpt"), validation_every=2,
              checkpoint_every=2)
    cfg = tsa.SATrainConfig(**kw, batch_slices=4, steps_per_dispatch=2,
                            device="cpu")
    tsa.train(cfg, max_iterations=2)
    ckpt = str(tmp_path / "ckpt" / cfg.model_name / "model-2.npz")
    jcfg = jsa.SATrainConfig(**kw)
    jsa.train(jcfg, max_iterations=4, resume_from=ckpt)
    out = tmp_path / "ckpt" / jcfg.model_name / "model-4.npz"
    _, _, _, params, _, extra = jstore.load_model(str(out))
    assert extra["iteration"] == 4
    count = jax.tree_util.tree_leaves(jstore.load_opt_state(
        str(out), optax.adam(LR).init(params)))[0]
    assert int(count) == 4
