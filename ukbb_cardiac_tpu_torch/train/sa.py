"""SA/LA FCN trainer — twin of ``common/train_network.py``, counterpart of
``ukbb_cardiac_tpu/train/sa.py``.

Reference semantics kept (file:line of ``train_network.py``):
- dataset scan of ``{train,validation,test}/<eid>/<seq>_{ED,ES}.nii.gz``
  + ``label_<seq>_{ED,ES}.nii.gz`` pairs (:125-138)
- n_class by sequence: sa=4, la_2ch=2, la_4ch=3 (:157-167)
- ``get_random_batch``: random subject pairs, centre crop to
  ``image_size``, rescale (1,99), per-slice 2D stacking, optional
  augmentation (:57-118); training uses rotate=10, scale=0.2 (:263)
- FCN with n_filter=[16*2^i], n_block=[2,2,3,3,3], same_dim=32, fc=64
  (:179-195); softmax CE loss (:204-206); Adam (:225)
- validation every 10 iterations with per-class Dice (:276-308);
  checkpoint every 1000 (:337-339); model-name encoding (:228-230)

As in the JAX trainer: metrics go to ``train_log.jsonl``, checkpoints are
model bundles (``ckpt/store.py``) that both packages read, and the
production options — fixed-size slice batches, K steps per call, device
augmentation, bf16 activations, compact transfer, a subject cache and a
device-resident slice pool — keep the batches the reference would draw.

On the card each step call (one step, or K) and the validation forward
are CUDA graphs of the trainer's own ``ProgramCache``, captured at each
key's first call and released when :func:`train` ends (``train/steps.py``):
the JAX trainer's jitted step, ``lax.scan`` over K steps and
``eval_forward``.  The validation forward is the deploy's (cuDNN encoder
and the fused head kernel); the head's folded, packed weights are
rebuilt on the device at every validation, since every update makes them
stale.

``mesh_devices`` N > 1 trains data-parallel over N ranks
(``train/distributed.py``; N cards, or N CPU processes with device
``cpu``), as the JAX trainer's mesh step does: each rank draws the same
global batches from the same seeded sampler and keeps its equal shard
(with the slice pool, each rank's own pool), BatchNorm statistics, the
augmentation and the aux metrics are the global batch's, gradients are
averaged.  Validation, the log and checkpoints are rank 0's.
"""

from __future__ import annotations

import json
import os
import random
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.ckpt import convert, store
from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.models import fcn as fcn_mod
from ukbb_cardiac_tpu_torch.models import losses
from ukbb_cardiac_tpu_torch.models.fused_head import apply_fcn_fused, fold_head
from ukbb_cardiac_tpu_torch.models.layers import batch_norm_group
from ukbb_cardiac_tpu_torch.ops.augment import (augment_with_params,
                                                data_augmenter,
                                                sample_shard_params)
from ukbb_cardiac_tpu_torch.ops.crop import crop_image
from ukbb_cardiac_tpu_torch.ops.intensity import rescale_intensity
from ukbb_cardiac_tpu_torch.reg.programs import ProgramCache
from ukbb_cardiac_tpu_torch.train import steps as steps_lib

N_CLASS = {"sa": 4, "la_2ch": 2, "la_4ch": 3, "la_4ch_seg4": 6}

# The production batch: 128 slices, a static shape.  With the
# linear-scaling rule the matching learning rate is 1e-3 * 128 / 20 (the
# CLI applies it when --learning_rate is not given); the trajectory
# differs from the reference's batch of 2 subjects, for which
# ``--profile reference`` stays.
PRODUCTION_BATCH_SLICES = 128


@dataclass
class SATrainConfig:
    seq_name: str = "sa"
    image_size: int = 192
    train_batch_size: int = 2
    validation_batch_size: int = 2
    train_iteration: int = 50000
    num_filter: int = 16
    num_level: int = 5
    learning_rate: float = 1e-3
    dataset_dir: str = ""
    checkpoint_dir: str = ""
    log_dir: str = ""
    validation_every: int = 10
    checkpoint_every: int = 1000
    seed: int = 0
    mesh_devices: int = 0  # >1: data-parallel over this many ranks
    device_augment: bool = False  # augment on the device, in the step
    # K optimizer steps per call (steps.make_multi_train_step); requires
    # batch_slices (a static batch shape to stack)
    steps_per_dispatch: int = 1
    # >0: each batch is exactly this many 2D slices from a FIFO pool of
    # subjects drawn one at a time; 0 keeps the reference's per-subject
    # batches
    batch_slices: int = 0
    # bf16 activations; params, BN statistics, logits and loss float32
    bf16: bool = False
    # batches cross to the device as f16 images + uint8 labels
    compact_transfer: bool = False
    # train on device-resident slices (train/device_pool.py); requires
    # batch_slices > 0 and device_augment.  Batches equal
    # compact_transfer's.
    device_slices: bool = False
    # device memory budget for the slice pool, GiB
    pool_gb: float = 2.0
    # >0: LRU cache of decoded, cropped, rescaled subjects, GiB; outputs
    # are identical to the uncached path
    cache_gb: float = 0.0
    # 'cuda' or 'cpu' (resolve_device: no silent fallback)
    device: Optional[str] = None

    @property
    def n_class(self) -> int:
        return N_CLASS[self.seq_name]

    @property
    def model_name(self) -> str:
        n_block = "22333"
        return (f"FCN_{self.seq_name}_level{self.num_level}_filter"
                f"{self.num_filter}_{n_block}_batch{self.train_batch_size}_"
                f"iter{self.train_iteration}_lr{self.learning_rate}")


def scan_dataset(dataset_dir: str, seq_name: str):
    """List (image, label) ED/ES file pairs per subset
    (``train_network.py:125-138``)."""
    data_list = {}
    for k in ("train", "validation", "test"):
        subset_dir = os.path.join(dataset_dir, k)
        data_list[k] = []
        if not os.path.isdir(subset_dir):
            continue
        for data in sorted(os.listdir(subset_dir)):
            data_dir = os.path.join(subset_dir, data)
            for fr in ("ED", "ES"):
                image_name = os.path.join(data_dir, f"{seq_name}_{fr}.nii.gz")
                label_name = os.path.join(data_dir,
                                          f"label_{seq_name}_{fr}.nii.gz")
                if os.path.exists(image_name) and os.path.exists(label_name):
                    data_list[k].append((image_name, label_name))
    return data_list


class SubjectCache:
    """Byte-budgeted LRU cache of decoded, cropped, rescaled subjects.

    Keyed by (image path, label path, crop size, both files' mtimes) so a
    rewritten file re-decodes.  Thread-safe: the prefetch worker and the
    validation draws may touch it concurrently."""

    def __init__(self, max_bytes: int):
        import collections
        import threading

        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._data = collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            value = self._data.get(key)
            if value is not None:
                self._data.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return value

    def put(self, key, value):
        nbytes = sum(a.nbytes for a in value)
        if nbytes > self.max_bytes:
            return
        with self._lock:
            if key in self._data:
                return
            self._data[key] = value
            self._bytes += nbytes
            while self._bytes > self.max_bytes:
                _, old = self._data.popitem(last=False)
                self._bytes -= sum(a.nbytes for a in old)


def _file_key(image_name, label_name, image_size):
    return (image_name, label_name, image_size,
            os.path.getmtime(image_name), os.path.getmtime(label_name))


def _load_subject(image_name, label_name, image_size, key, cache):
    """Decoded, centre-cropped, rescaled (image float32, label int32)
    volumes, or None (with the reference's message) for a mismatched or
    blank pair."""
    cached = cache.get(key) if cache is not None else None
    if cached is not None:
        return cached
    image = np.asarray(nifti.load(image_name).dataobj, dtype=np.float32)
    label = np.asarray(nifti.load(label_name).dataobj)
    if image.shape != label.shape:
        print(f"Error: mismatched size, image.shape = {image.shape}, "
              f"label.shape = {label.shape}")
        print(f"Skip {image_name}, {label_name}")
        return None
    if image.max() < 1e-6:
        print(f"Error: blank image, image.max = {image.max()}")
        print(f"Skip {image_name} {label_name}")
        return None
    X, Y = image.shape[:2]
    cx, cy = X // 2, Y // 2
    image = crop_image(image, cx, cy, image_size)
    label = crop_image(label, cx, cy, image_size)
    image = rescale_intensity(image, (1.0, 99.0))
    label = np.asarray(label, dtype=np.int32)
    if cache is not None:
        cache.put(key, (image, label))
    return image, label


def get_random_batch(filename_list, batch_size, image_size=192,
                     data_augmentation=False, shift=0.0, rotate=0.0,
                     scale=0.0, intensity=0.0, flip=False, rng=None,
                     verbose=False, cache: Optional[SubjectCache] = None):
    """Host batch sampler (``train_network.py:57-118``): random subject
    volumes, centre crop, rescale, per-slice 2D stacking, optional host
    augmentation.  ``cache`` skips the decode of subjects drawn before;
    outputs are identical either way."""
    rng = rng or random
    n_file = len(filename_list)
    images, labels = [], []
    n_selected = 0
    while n_selected < batch_size:
        image_name, label_name = filename_list[rng.randrange(n_file)]
        if not (os.path.exists(image_name) and os.path.exists(label_name)):
            continue
        if verbose:
            print(f"  Select {image_name} {label_name}")
        key = (_file_key(image_name, label_name, image_size)
               if cache is not None else None)
        got = _load_subject(image_name, label_name, image_size, key, cache)
        if got is None:
            continue
        image, label = got
        for z in range(image.shape[2]):
            images.append(image[:, :, z])
            labels.append(label[:, :, z])
        n_selected += 1

    images = np.asarray(images, dtype=np.float32)[..., None]
    labels = np.asarray(labels, dtype=np.int32)
    if data_augmentation:
        # the augmentation RNG derives from the sampler's, so a fixed seed
        # reproduces the whole batch stream
        np_rng = (np.random.RandomState(rng.randrange(2 ** 31))
                  if rng is not random else None)
        images, labels = data_augmenter(images, labels, shift=shift,
                                        rotate=rotate, scale=scale,
                                        intensity=intensity, flip=flip,
                                        rng=np_rng)
    return images, labels


def make_slice_pool_sampler(filename_list, batch_slices: int,
                            image_size=192, data_augmentation=False,
                            shift=0.0, rotate=0.0, scale=0.0, intensity=0.0,
                            flip=False, rng=None,
                            cache: Optional[SubjectCache] = None):
    """Fixed-shape batch sampler: subjects drawn one at a time exactly as
    :func:`get_random_batch` draws them, their slices pooled in FIFO
    order, batches of exactly ``batch_slices`` slices popped off."""
    buf_img: list = []
    buf_lab: list = []

    def next_batch():
        while len(buf_img) < batch_slices:
            images, labels = get_random_batch(
                filename_list, 1, image_size=image_size,
                data_augmentation=data_augmentation, shift=shift,
                rotate=rotate, scale=scale, intensity=intensity, flip=flip,
                rng=rng, cache=cache)
            buf_img.extend(images)
            buf_lab.extend(labels)
        images = np.asarray(buf_img[:batch_slices], dtype=np.float32)
        labels = np.asarray(buf_lab[:batch_slices], dtype=np.int32)
        del buf_img[:batch_slices], buf_lab[:batch_slices]
        return {"image": images, "label": labels}

    return next_batch


def make_device_slice_sampler(filename_list, batch_slices: int, pool,
                              image_size=192, rng=None,
                              cache: Optional[SubjectCache] = None):
    """Index-batch sampler over a :class:`train.device_pool.DeviceCinePool`
    whose slots hold subject-frame volumes as (Z, S, S) slice stacks.

    Draws subjects with exactly :func:`make_slice_pool_sampler`'s
    semantics (one ``randrange`` per subject, the same gates, slices FIFO
    in z order) but makes the subject's volume device-resident and emits
    {"slot": (B,), "zidx": (B,)} int32 batches.  Per-subject Z is memoised
    by file key, so the steady state decodes nothing.  Every emitted slice
    pins its slot; the consumer unpins each batch's slots once the step
    gathering them has been enqueued."""
    rng = rng or random
    n_file = len(filename_list)
    meta = {}  # key -> Z (0 = invalid subject)
    buf: list = []

    def draw():
        image_name, label_name = filename_list[rng.randrange(n_file)]
        if not (os.path.exists(image_name) and os.path.exists(label_name)):
            return
        key = _file_key(image_name, label_name, image_size)
        z = meta.get(key)
        first = None
        if z is None:
            # keep the decoded volume for the upload below: without a
            # SubjectCache a miss would otherwise decode twice
            first = _load_subject(image_name, label_name, image_size, key,
                                  cache)
            meta[key] = z = 0 if first is None else first[0].shape[2]
        if z == 0:
            return

        def make_host(first=first):
            got = first if first is not None else _load_subject(
                image_name, label_name, image_size, key, cache)
            if got is None:
                raise RuntimeError(f"subject {image_name} failed to "
                                   "re-load for pool upload")
            image, label = got
            return (np.transpose(image, (2, 0, 1)),
                    np.transpose(label, (2, 0, 1)))

        slot = pool.ensure(key, make_host)
        for zi in range(z):
            pool.pin(slot)
            buf.append((slot, zi))

    def next_batch():
        while len(buf) < batch_slices:
            draw()
        take = buf[:batch_slices]
        del buf[:batch_slices]
        return {"slot": np.asarray([s for s, _ in take], np.int32),
                "zidx": np.asarray([zi for _, zi in take], np.int32)}

    return next_batch


def make_fcn_loss(net: fcn_mod.FCN, cfg: fcn_mod.FCNConfig,
                  device_augment: bool = False, shift=0.0, rotate=10.0,
                  scale=0.2, intensity=0.0, flip=False, compute_dtype=None,
                  group=None):
    """Loss closure for the train step: softmax CE + accuracy / Dice aux
    (``train_network.py:204-214``).  ``loss_fn(batch, seed) -> (loss,
    aux)``; the training forward updates the BN moving statistics.

    ``device_augment``: the random affine augmentation runs on the device,
    in the step, from a generator seeded with the step's ``seed``:
    ``loss_fn.draw(seed, n, device)`` makes a batch of ``n`` rows' draws
    and ``loss_fn.apply(batch, draws)`` is the loss on them (the step
    builders draw before a call, ``train/steps.py``); ``loss_fn.draw`` is
    None without it.
    ``compute_dtype``: activation dtype (default float32); bfloat16 keeps
    params, BN statistics, logits and the loss in float32.
    ``group``: the process group of a data-parallel step
    (``steps.make_dp_train_step``), the batch this rank's equal shard:
    BatchNorm takes the global batch's statistics, the augmentation draws
    the global batch's parameters and keeps this rank's rows, and the aux
    metrics are the global batch's.  The loss stays the shard's mean."""
    dtype = compute_dtype or torch.float32
    generators = {}
    shard = steps_lib.group_shard(group)
    classes = [(f"dice_{k}", k) for k in range(1, cfg.n_class)]

    def draw(seed: int, n: int, device):
        gen = generators.get(device)
        if gen is None:
            gen = generators[device] = torch.Generator(device=device)
        gen.manual_seed(seed)
        return sample_shard_params(gen, n, shift, rotate, scale, intensity,
                                   device, shard)

    def apply(batch, draws):
        # compact batches (f16 image / uint8 label) are cast here
        image = batch["image"].float()
        label = batch["label"].to(torch.int32)
        if draws is not None:
            image, label = augment_with_params(image, label, draws, flip)
        with batch_norm_group(net, group):
            logits = fcn_mod.apply_fcn(net, image, compute_dtype=dtype,
                                       train=True)
        loss = losses.softmax_cross_entropy(logits, label, cfg.n_class)
        pred = torch.argmax(logits.detach(), dim=-1)
        return loss, steps_lib.segmentation_aux(pred, label, classes, group)

    def loss_fn(batch, seed: int):
        image = batch["image"]
        return apply(batch, draw(seed, image.shape[0], image.device)
                     if device_augment else None)

    loss_fn.draw = draw if device_augment else None
    loss_fn.apply = apply
    return loss_fn


def _pool_for(cfg: SATrainConfig, train_list, K: int, device,
              verbose: bool = True):
    """A :class:`DeviceCinePool` sized from a header-only scan of the
    training volumes and ``cfg.pool_gb``."""
    from ukbb_cardiac_tpu_torch.train.device_pool import DeviceCinePool

    z_max = z_min = 0
    for image_name, _label in train_list:
        try:
            shape = nifti.read_shape(image_name)
        except Exception:
            continue
        if len(shape) >= 3 and shape[2] > 0:
            z_max = max(z_max, int(shape[2]))
            z_min = int(shape[2]) if z_min == 0 else min(z_min,
                                                         int(shape[2]))
    if z_max <= 0:
        raise ValueError("device_slices: no readable 3D training volume")
    s = cfg.image_size
    bytes_per_slot = z_max * s * s * 3  # f16 image + uint8 label
    budget_slots = int(cfg.pool_gb * (1 << 30) / bytes_per_slot)
    # worst case pinned at once: the prefetch queue (depth K+1), the chunk
    # in flight and the one under construction, each batch spanning
    # ceil(B / z_min) + 1 subjects
    per_batch = -(-cfg.batch_slices // max(z_min, 1)) + 1
    min_slots = min(len(train_list), (2 * K + 2) * per_batch + 4)
    n_slots = min(len(train_list), max(budget_slots, 1))
    if n_slots < min_slots:
        raise ValueError(
            f"device_slices: pool_gb={cfg.pool_gb} holds {n_slots} volumes "
            f"({bytes_per_slot / 2 ** 20:.1f} MiB each) but one dispatch "
            f"chunk may pin {min_slots}; raise pool_gb or lower "
            "batch_slices/steps_per_dispatch")
    pool = DeviceCinePool(n_slots, z_max, s, s, device)
    if verbose:
        print(f"Device slice pool: {n_slots} slots x Z{z_max} @ {s}x{s} "
              f"({pool.nbytes / 2 ** 30:.2f} GiB)")
    return pool


def _check_config(cfg: SATrainConfig, K: int, world: int):
    if K > 1 and cfg.batch_slices <= 0:
        raise ValueError("steps_per_dispatch > 1 requires batch_slices "
                         "(a static batch shape to stack K batches)")
    if cfg.device_slices:
        if cfg.batch_slices <= 0:
            raise ValueError("device_slices requires batch_slices (the "
                             "pool gather needs a static batch shape)")
        if not cfg.device_augment:
            raise ValueError("device_slices requires device_augment: the "
                             "pool holds un-augmented slices, so the "
                             "affine augmentation must run in-step")
    if world > 1 and cfg.batch_slices > 0 and cfg.batch_slices % world:
        # checked whatever K is; with batch_slices 0 (per-subject
        # batches) each batch must divide, and one that does not raises
        # at its step
        raise ValueError("batch_slices must divide evenly over "
                         f"mesh_devices ({cfg.batch_slices} % "
                         f"{world} != 0)")


def train(cfg: SATrainConfig, max_iterations: Optional[int] = None,
          progress_every: int = 100, resume_from: Optional[str] = None, *,
          devices=None, backend: Optional[str] = None):
    """Run the training loop.  Returns (net, names, model_cfg, stats).

    ``resume_from``: a bundle written by this trainer or by the JAX
    package's — restores params, BN state, Adam state and the iteration
    counter, adopting the bundle's architecture.  ``stats``: iterations
    run, and from the end of the first call on (warm-up excluded) the
    step loop's seconds (validation and checkpoints excluded), the
    seconds it waited for the next chunk, and the steps it ran.

    With ``mesh_devices`` > 1 the ranks run in processes of their own
    and the returned net and stats are rank 0's, the net on its device.
    ``devices`` / ``backend`` name the ranks' devices and the group's
    backend instead (``train/distributed.py``: several ranks on one card
    over gloo, or one NCCL rank)."""
    K = max(1, int(cfg.steps_per_dispatch))
    world = len(devices) if devices is not None else cfg.mesh_devices
    _check_config(cfg, K, world)
    device = resolve_device(cfg.device)
    if devices is None and cfg.mesh_devices <= 1:
        return _train(cfg, K, device, max_iterations, progress_every,
                      resume_from)
    from ukbb_cardiac_tpu_torch.train import distributed

    ranks = distributed.rank_devices(world, cfg.device, devices)
    sd, names, model_cfg, stats = distributed.run(
        train_rank, (cfg, K, max_iterations, progress_every, resume_from),
        ranks, backend)
    net = fcn_mod.FCN(model_cfg)
    net.load_state_dict(sd)
    return (net.to(ranks[0], memory_format=torch.channels_last), names,
            model_cfg, stats)


def train_rank(rank, cfg: SATrainConfig, K: int,
               max_iterations: Optional[int] = None,
               progress_every: int = 100, resume_from: Optional[str] = None):
    """One data-parallel rank's share of :func:`train` (``rank`` a
    ``distributed.Rank``; :func:`train` spawns the ranks with it, or a
    caller runs it with other jobs through ``distributed.run_in_turn``).
    Returns the state dict on the CPU with the names, config and stats
    (``distributed.rank_stats``, with the peak memory of this job alone,
    and the head kernel's launches in this rank's validations)."""
    from ukbb_cardiac_tpu_torch.models.fused_head import fused_head
    from ukbb_cardiac_tpu_torch.train.distributed import rank_stats

    _check_config(cfg, K, rank.world)
    started = time.time()
    launched = fused_head.launches
    if rank.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(rank.device)
    net, names, model_cfg, stats = _train(
        cfg, K, resolve_device(str(rank.device)), max_iterations,
        progress_every, resume_from, rank)
    stats = rank_stats(rank, stats, started)
    stats["fused_head_launches"] = fused_head.launches - launched
    return ({k: v.cpu() for k, v in net.state_dict().items()}, names,
            model_cfg, stats)


def _train(cfg: SATrainConfig, K: int, device, max_iterations,
           progress_every, resume_from, rank=None):
    """The training loop on ``device``; in a data-parallel ``rank``
    (``distributed.Rank``) its share of it."""
    group = rank.group if rank is not None else None
    shard = (rank.rank, rank.world) if rank is not None else None
    lead = rank is None or rank.rank == 0
    data_list = scan_dataset(cfg.dataset_dir, cfg.seq_name)
    if not data_list["train"]:
        raise FileNotFoundError(
            f"no training pairs under {cfg.dataset_dir}/train")

    n_filter = tuple(cfg.num_filter * (2 ** i) for i in range(cfg.num_level))
    model_cfg = fcn_mod.FCNConfig(n_class=cfg.n_class, n_level=cfg.num_level,
                                  n_filter=n_filter, n_block=(2, 2, 3, 3, 3),
                                  same_dim=32, fc=64)
    start_iteration = 0
    if resume_from:
        # the bundle is self-describing: adopt ITS architecture
        kind, model_cfg, names, params, state, extra = \
            store.load_model_with_extra(resume_from)
        if kind != "fcn":
            raise ValueError(f"cannot resume FCN training from a {kind!r} "
                             "bundle")
        net = convert.fcn_from_jax(params, state, names, model_cfg)
        start_iteration = int(extra.get("iteration", 0))
        if lead:
            print(f"Resumed from {resume_from} at iteration "
                  f"{start_iteration}.")
    else:
        names = convert.fcn_names(model_cfg)
        net = fcn_mod.init_weights(fcn_mod.FCN(model_cfg),
                                   torch.Generator().manual_seed(cfg.seed))
    # channels-last (NHWC) weights make every activation channels-last:
    # cuDNN's bf16 convolutions then skip their layout transposes, and
    # the train-mode BatchNorm takes PyTorch's channels-last kernels,
    # which parallelise over pixels (the NCHW ones run a block per
    # channel, 16-64 blocks here).  1.7x per production step on an H100
    # (PERF.md, section 6).
    net = net.to(device, memory_format=torch.channels_last)
    layout = convert.fcn_layout(names, model_cfg)
    optimizer = steps_lib.Adam(net.parameters(), lr=cfg.learning_rate)
    if resume_from:
        leaves = store.load_opt_state(resume_from)
        if leaves is not None:
            convert.load_adam_leaves(optimizer, net, layout, leaves)

    loss_fn = make_fcn_loss(net, model_cfg, device_augment=cfg.device_augment,
                            compute_dtype=torch.bfloat16 if cfg.bf16 else None,
                            group=group)
    # the trainer's programs (train/steps.py): built from here on, after
    # the weights, the Adam state and the memory format are final; they
    # read every parameter and state tensor by address, and go at the end
    programs = ProgramCache(max_bytes=steps_lib.TRAINER_BYTES)
    step, multi_step = make_steps(loss_fn, optimizer, group, programs,
                                  cfg.device_slices, "slice")

    model_dir = os.path.join(cfg.checkpoint_dir or ".", cfg.model_name)
    if lead:
        os.makedirs(model_dir, exist_ok=True)
        log_f = open(os.path.join(model_dir, "train_log.jsonl"), "a")

    rng = random.Random(cfg.seed + start_iteration)
    # validation draws its own stream, so queue timing cannot change what
    # a fixed seed samples
    val_rng = random.Random(cfg.seed + 7_777_777 + start_iteration)
    total = max_iterations or cfg.train_iteration
    if lead:
        print("Start training...")
    start_time = time.time()

    from ukbb_cardiac_tpu_torch.train.prefetch import (BatchPrefetcher,
                                                       make_chunk_builder,
                                                       make_pool_chunk_builder,
                                                       make_stage, run_chunks)

    cache = (SubjectCache(int(cfg.cache_gb * (1 << 30)))
             if cfg.cache_gb > 0 else None)
    pool = None
    if cfg.device_slices:
        pool = _pool_for(cfg, data_list["train"], K, device, lead)
        sample = make_device_slice_sampler(
            data_list["train"], cfg.batch_slices, pool,
            image_size=cfg.image_size, rng=rng, cache=cache)
    elif cfg.batch_slices > 0:
        sample = make_slice_pool_sampler(
            data_list["train"], cfg.batch_slices, image_size=cfg.image_size,
            data_augmentation=not cfg.device_augment, shift=0, rotate=10,
            scale=0.2, intensity=0, flip=False, rng=rng, cache=cache)
    else:
        def sample():
            images, labels = get_random_batch(
                data_list["train"], cfg.train_batch_size,
                image_size=cfg.image_size,
                data_augmentation=not cfg.device_augment, shift=0, rotate=10,
                scale=0.2, intensity=0, flip=False, rng=rng, cache=cache)
            return {"image": images, "label": labels}

    if cfg.compact_transfer and not cfg.device_slices:
        def make_batch():
            b = sample()
            return {"image": b["image"].astype(np.float16),
                    "label": b["label"].astype(np.uint8)}
    else:
        make_batch = sample

    prefetcher = BatchPrefetcher(make_batch, depth=2 if K == 1 else K + 1)
    cadences = (cfg.validation_every, cfg.checkpoint_every, progress_every)
    stage = make_stage(device)
    if cfg.device_slices:
        build_input = make_pool_chunk_builder(prefetcher, pool, K, total,
                                              cadences, stage, shard)
    else:
        build_input = make_chunk_builder(prefetcher, K, total, cadences,
                                         stage, shard)

    def side_work(iteration, loss, aux, t0, k_now):
        if not lead:
            return
        if iteration % cfg.validation_every == 0 and \
                data_list["validation"]:
            v_images, v_labels = get_random_batch(
                data_list["validation"], cfg.validation_batch_size,
                image_size=cfg.image_size, rng=val_rng, cache=cache)
            v_pred = validation_predict(net, v_images, device, programs)
            rec = {"iteration": iteration, "loss": float(loss),
                   "accuracy": float(aux["accuracy"]),
                   "val_accuracy": float(np.mean(v_pred == v_labels)),
                   # per iteration, whatever K the call ran
                   "seconds": (time.time() - t0) / k_now}
            for k in range(1, cfg.n_class):
                a, b = v_pred == k, v_labels == k
                rec[f"val_dice_{k}"] = float(
                    2 * np.sum(a & b) / max(np.sum(a) + np.sum(b), 1e-7))
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()

        if iteration % progress_every == 0:
            print(f"Iteration {iteration}/{total}: loss = "
                  f"{float(loss):.4f}, {(time.time() - t0) / k_now:.3f}"
                  "s/iter")

        if iteration % cfg.checkpoint_every == 0 or iteration == total:
            save_checkpoint(os.path.join(model_dir,
                                         f"model-{iteration}.npz"),
                            net, names, optimizer, layout,
                            {"iteration": iteration,
                             "seq_name": cfg.seq_name})

    try:
        stats = run_chunks(build_input, step, multi_step, cfg.device_slices,
                           start_iteration, total, cadences, device,
                           side_work)
        stats["programs"] = program_stats(programs)
        stats["route"] = multi_step.route
    finally:
        prefetcher.close()
        programs.clear()
        if lead:
            log_f.close()
    if lead:
        print(f"Training took {time.time() - start_time:.3f}s.")
    return net, names, model_cfg, stats


def make_steps(loss_fn, optimizer, group, programs, pooled: bool,
               kind: str):
    """The trainers' (step, multi_step) pair (``prefetch.run_chunks``):
    the pool's K-step call of ``kind`` ("slice" or "window") when
    ``pooled`` (step None), else the single and K-step builders; the
    data-parallel ones in a rank of ``group``.  All are programs of
    ``programs`` on the card (``train/steps.py``)."""
    from ukbb_cardiac_tpu_torch.train import device_pool

    if pooled:
        make = {("slice", False): device_pool.make_pool_slice_multi_step,
                ("window", False): device_pool.make_pool_window_multi_step,
                ("slice", True): device_pool.make_pool_slice_multi_dp_step,
                ("window", True): device_pool.make_pool_window_multi_dp_step}[
            kind, group is not None]
        args = (loss_fn, optimizer) + ((group,) if group is not None else ())
        return None, make(*args, programs=programs)
    if group is None:
        return (steps_lib.make_train_step(loss_fn, optimizer,
                                          programs=programs),
                steps_lib.make_multi_train_step(loss_fn, optimizer,
                                                programs=programs))
    return (steps_lib.make_dp_train_step(loss_fn, optimizer, group,
                                         programs=programs),
            steps_lib.make_multi_dp_train_step(loss_fn, optimizer, group,
                                               programs=programs))


def program_stats(programs: ProgramCache) -> list:
    """Each of a trainer's captured programs: what it computes, its first
    input's shape (K and the batch for a step), the host seconds of its
    capture, the bytes its graph's pool reserved, its replays."""
    return [{"tag": p.key[0][0], "first_input": list(p.key[2][0]),
             "capture_s": p.capture_s, "reserved": p.reserved,
             "replays": p.replays}
            for p in programs.programs() if p.graph is not None]


@torch.no_grad()
def validation_predict(net: fcn_mod.FCN, images: np.ndarray,
                       device, programs: Optional[ProgramCache] = None
                       ) -> np.ndarray:
    """Argmax labels (N, X, Y) of the inference forward on (N, X, Y, 1)
    images: the deploy's encoder and fused head (on the card the head
    kernel), the head's BatchNorms folded into its weights and packed
    afresh from the current parameters on the device on every call (every
    update makes them stale).  With ``programs`` (the trainer's) on the
    card the whole forward -- fold, pack, encoder, head kernel, argmax --
    is one program per batch shape, the JAX trainer's jitted
    ``eval_forward``."""
    x = torch.from_numpy(images).to(device)

    def forward(x):
        head = fold_head(net)
        if x.device.type == "cuda":  # the kernel's packing (the CPU's
            head.pack_on_device()    # plain head reads the folded weights)
        return (torch.argmax(apply_fcn_fused(net, x, head), dim=1),)

    if programs is None:
        (labels,) = forward(x)
    else:
        (labels,) = programs.run(("sa_validation",), forward, x)
    return labels.cpu().numpy()


def save_checkpoint(path: str, net: fcn_mod.FCN, names, optimizer,
                    layout, extra_meta: dict) -> None:
    """Write the model and Adam state as a bundle both packages read."""
    params, state = convert.fcn_to_jax(net, names)
    kind = "resnet" if isinstance(net, fcn_mod.ResNetFCN) else "fcn"
    store.save_model(path, kind, net.cfg, names, params, state,
                     extra_meta=extra_meta,
                     opt_leaves=convert.adam_leaves(optimizer, net, layout))
