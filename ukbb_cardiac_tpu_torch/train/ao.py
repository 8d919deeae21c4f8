"""Aortic trainer — twin of ``common/train_network_ao.py``, counterpart of
``ukbb_cardiac_tpu/train/ao.py``.

Reference semantics kept (file:line of ``train_network_ao.py``):
- flags and defaults: image_size 256 (:29-30), batch 5, 20k iterations,
  n_class 3 BG/AAo/DAo (:265-268), n_block (2, 2, 2, 2, 2) (:284),
  z-score by default (:65-66)
- ``get_random_batch``: subjects with temporally sparse annotations; a
  circular time window around every annotated frame (:159-187); the
  densely propagated ``label_ao_prop`` when present, else the centre
  frame's annotation repeated over the window (:181-187);
  window-consistent augmentation (:193-196)
- model switch UNet / UNet-LSTM / Temporal-UNet (:285-317); UNet-LSTM's
  window 2 * weight_R - 1 (:294)
- two-phase training: restore a pre-trained U-Net (BN moving statistics
  included, :407-414) and train only the LSTM head unless
  ``joint_train`` (:350-362).  The JAX trainer zeroes the U-Net's
  updates (``optax.multi_transform`` with ``set_to_zero``); here Adam is
  built over the LSTM's parameters only and the U-Net runs outside
  autograd in inference mode, so its parameters and BN statistics stay
  bitwise unchanged.
- piecewise-constant lr decay via ``reduce_lr_after`` (:329-339)
- model-name hyperparameter encoding (:365-381)

As in the JAX trainer: metrics go to ``train_log.jsonl`` every
``validation_every`` iterations, checkpoints are ``unet`` / ``unet_lstm``
/ ``temporal_unet`` bundles (``ckpt/store.py``) without optimizer state,
which both packages read, and the production options — fixed-size window
batches, K steps per call, device augmentation, bf16 activations, compact
transfer, a subject cache and a device-resident cine pool — keep the
windows the reference would draw.  ``mesh_devices`` N > 1 trains
data-parallel over N ranks (``train/distributed.py``), as the SA trainer
does (``train/sa.py``); as in the JAX trainer it needs ``batch_windows``
divisible by N.  On the card each step call (one step or K, either
phase; the ConvLSTM's scan forward and backward inside it) and the
validation loss are CUDA graphs of the trainer's own ``ProgramCache``,
released when :func:`train` ends, as in the SA trainer.
"""

from __future__ import annotations

import json
import os
import random
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.ckpt import convert, store
from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.models import convlstm, wrappers
from ukbb_cardiac_tpu_torch.models.fcn import init_weights
from ukbb_cardiac_tpu_torch.models.layers import batch_norm_group
from ukbb_cardiac_tpu_torch.models.unet import UNet, UNetConfig
from ukbb_cardiac_tpu_torch.ops.augment import (aortic_augment_with_params,
                                                aortic_data_augmenter,
                                                sample_shard_params)
from ukbb_cardiac_tpu_torch.ops.crop import crop_image
from ukbb_cardiac_tpu_torch.ops.intensity import (normalise_intensity,
                                                  rescale_intensity)
from ukbb_cardiac_tpu_torch.reg.programs import ProgramCache
from ukbb_cardiac_tpu_torch.train import steps as steps_lib
from ukbb_cardiac_tpu_torch.train.sa import (SubjectCache, make_steps,
                                             program_stats)

KINDS = {"UNet": "unet", "UNet-LSTM": "unet_lstm",
         "Temporal-UNet": "temporal_unet"}


@dataclass
class AoTrainConfig:
    seq_name: str = "ao"
    model: str = "UNet"        # 'UNet' | 'UNet-LSTM' | 'Temporal-UNet'
    image_size: int = 256
    train_batch_size: int = 5
    validation_batch_size: int = 5
    num_filter: int = 16
    num_level: int = 5
    num_hidden: int = 16
    train_iteration: int = 20000
    learning_rate: float = 1e-3
    reduce_lr_after: Sequence[int] = ()
    dataset_dir: str = ""
    checkpoint_dir: str = "model"
    log_dir: str = "log"
    model_path: str = ""       # pre-trained U-Net bundle for UNet-LSTM
    z_score: bool = True
    bidirectional: bool = True
    seq2seq: bool = True
    weight_R: int = 5
    weight_r: float = 0.0
    joint_train: bool = False
    from_scratch: bool = False
    validation_every: int = 10
    checkpoint_every: int = 1000
    seed: int = 0
    # >0: LRU cache of decoded cines, GiB (train.sa.SubjectCache)
    cache_gb: float = 0.0
    # batches cross to the device as f16 images + uint8 labels
    compact_transfer: bool = False
    # >0: each batch is exactly this many time windows from a FIFO pool
    # of subjects drawn one at a time (a static batch shape); 0 keeps the
    # reference's per-subject batches
    batch_windows: int = 0
    # K optimizer steps per call; requires batch_windows
    steps_per_dispatch: int = 1
    # window-consistent affine augmentation on the device, in the step
    device_augment: bool = False
    # bf16 activations (the ConvLSTM's cell state stays float32);
    # params, BN statistics, logits and loss float32
    bf16: bool = False
    mesh_devices: int = 0      # >1: data-parallel over this many ranks
    # keep normalised cines resident on the device and gather each
    # step's windows there (train/device_pool.py); requires batch_windows
    # and device_augment
    device_windows: bool = False
    # device memory budget for the cine pool, GiB
    pool_gb: float = 2.0
    # 'cuda' or 'cpu' (resolve_device: no silent fallback)
    device: Optional[str] = None

    @property
    def n_class(self) -> int:
        return 3

    @property
    def time_window(self) -> int:
        return 1 if self.model == "UNet" else self.weight_R * 2 - 1

    @property
    def model_name(self) -> str:
        name = (f"{self.model}_{self.seq_name}_level{self.num_level}_"
                f"filter{self.num_filter}_22222_batch"
                f"{self.train_batch_size}_iter{self.train_iteration}_lr"
                f"{self.learning_rate}")
        if self.z_score:
            name += "_zscore"
        if self.model == "UNet-LSTM":
            name += f"_tw{self.time_window}_h{self.num_hidden}"
            if self.bidirectional:
                name += "_bidir"
            if self.seq2seq:
                name += f"_seq2seq_wR{self.weight_R}_wr{self.weight_r}"
            if self.joint_train:
                name += "_joint"
            if self.from_scratch:
                name += "_scratch"
        if self.model == "Temporal-UNet":
            name += (f"_tw{self.time_window}_wR{self.weight_R}"
                     f"_wr{self.weight_r}")
        return name


def scan_dataset_ao(dataset_dir: str, seq_name: str = "ao"):
    """(image, label[, label_prop]) triples per subset
    (``train_network_ao.py:223-238``)."""
    data_list = {}
    for k in ("train", "validation"):
        subset_dir = os.path.join(dataset_dir, k)
        data_list[k] = []
        if not os.path.isdir(subset_dir):
            continue
        for data in sorted(os.listdir(subset_dir)):
            data_dir = os.path.join(subset_dir, data)
            image_name = os.path.join(data_dir, f"{seq_name}.nii.gz")
            label_name = os.path.join(data_dir, f"label_{seq_name}.nii.gz")
            prop_name = os.path.join(data_dir,
                                     f"label_{seq_name}_prop.nii.gz")
            if os.path.exists(image_name) and os.path.exists(label_name):
                if os.path.exists(prop_name):
                    data_list[k].append((image_name, label_name, prop_name))
                else:
                    data_list[k].append((image_name, label_name))
    return data_list


def _subject_key(entry, image_size, z_score):
    image_name, label_name = entry[0], entry[1]
    prop_name = entry[2] if len(entry) == 3 else None
    return (image_name, label_name, prop_name, image_size, z_score,
            os.path.getmtime(image_name), os.path.getmtime(label_name),
            os.path.getmtime(prop_name) if prop_name else None)


def _load_subject_ao(entry, image_size=256, z_score=True,
                     cache: Optional[SubjectCache] = None, verbose=False):
    """Decode, crop and normalise one subject's (image, label[, prop])
    triple (``train_network_ao.py:98-155``).  Returns (image float32 (X, Y,
    1, T) normalised, label int32, label_prop int32 or None), or None when
    the reference's gates reject the subject (mismatched shapes, blank
    image; same messages)."""
    image_name, label_name = entry[0], entry[1]
    label_prop_name = entry[2] if len(entry) == 3 else None
    if not (os.path.exists(image_name) and os.path.exists(label_name)):
        return None
    if verbose:
        print(f"  Select {image_name} {label_name}")
    ckey = cached = None
    if cache is not None:
        ckey = _subject_key(entry, image_size, z_score)
        cached = cache.get(ckey)
    if cached is not None:
        image, label, label_prop = cached
    else:
        image = np.asanyarray(nifti.load(image_name).dataobj).astype(
            np.float32)
        label = np.asanyarray(nifti.load(label_name).dataobj)
        label_prop = (np.asanyarray(nifti.load(label_prop_name).dataobj)
                      if label_prop_name else None)

        if image.shape != label.shape:
            print(f"Error: mismatched size, image.shape = {image.shape}, "
                  f"label.shape = {label.shape}")
            return None
        if label_prop is not None and image.shape != label_prop.shape:
            print(f"Error: mismatched size, image.shape = {image.shape}, "
                  f"label_prop.shape = {label_prop.shape}")
            return None
        if image.max() < 1e-6:
            print(f"Error: blank image, image.max = {image.max()}")
            return None

        X, Y = image.shape[:2]
        cx, cy = X // 2, Y // 2
        image = crop_image(image, cx, cy, image_size)
        label = crop_image(label, cx, cy, image_size)
        if label_prop is not None:
            label_prop = crop_image(label_prop, cx, cy, image_size)

        if z_score:
            image = normalise_intensity(image, 10.0)
        else:
            image = rescale_intensity(image, (1.0, 99.0))
        label = np.asarray(label, dtype=np.int32)
        if label_prop is not None:
            label_prop = np.asarray(label_prop, dtype=np.int32)
        if cache is not None:
            cache.put(ckey, (image, label,
                             label_prop if label_prop is not None
                             else np.empty(0, np.int32)))
    if isinstance(label_prop, np.ndarray) and label_prop.size == 0:
        label_prop = None
    return image, label, label_prop


def get_random_batch_ao(filename_list, batch_size, image_size=256,
                        time_window=1, z_score=True, flatten=False,
                        data_augmentation=False, shift=0.0, rotate=0.0,
                        scale=0.0, intensity=0.0, flip=False, rng=None,
                        verbose=False, cache: Optional[SubjectCache] = None):
    """Sparse-annotation window sampler (``train_network_ao.py:98-216``).

    Returns images (N, T, X, Y, 1) and labels (N, T, X, Y); with
    ``flatten`` (UNet mode) the window axis folds into the batch.
    ``cache`` skips the decode of cines drawn before; outputs are
    identical either way."""
    rng = rng or random
    n_file = len(filename_list)
    images, labels = [], []
    n_selected = 0
    while n_selected < batch_size:
        entry = filename_list[rng.randrange(n_file)]
        loaded = _load_subject_ao(entry, image_size=image_size,
                                  z_score=z_score, cache=cache,
                                  verbose=verbose)
        if loaded is None:
            continue
        image, label, label_prop = loaded
        T = image.shape[3]

        t_anno = np.nonzero(np.sum(label > 0, axis=(0, 1, 2)))[0]
        if len(t_anno) == 0:
            # an all-background label contributes no windows
            print(f"Error: no annotated frame in {entry[1]}, skip.")
            continue
        rad = (time_window - 1) // 2
        for t in t_anno:
            idx = [(i + T) % T for i in range(t - rad, t + rad + 1)]
            image_idx = np.transpose(image[:, :, 0, idx], (2, 0, 1))[..., None]
            if label_prop is not None:
                label_idx = np.transpose(label_prop[:, :, 0, idx], (2, 0, 1))
            else:
                label_idx = np.repeat(label[:, :, 0, t][None], time_window,
                                      axis=0)
            if data_augmentation:
                np_rng = (np.random.RandomState(rng.randrange(2 ** 31))
                          if rng is not random else None)
                image_idx, label_idx = aortic_data_augmenter(
                    image_idx, label_idx, shift=shift, rotate=rotate,
                    scale=scale, intensity=intensity, flip=flip, rng=np_rng)
            images.append(image_idx)
            labels.append(label_idx)
        n_selected += 1

    images = np.asarray(images, dtype=np.float32)
    labels = np.asarray(labels, dtype=np.int32)
    if flatten:
        images = images.reshape((-1,) + images.shape[2:])
        labels = labels.reshape((-1,) + labels.shape[2:])
    return images, labels


def make_window_pool_sampler(filename_list, batch_windows: int,
                             image_size=256, time_window=1, z_score=True,
                             flatten=False, data_augmentation=False,
                             shift=0.0, rotate=0.0, scale=0.0, intensity=0.0,
                             flip=False, rng=None,
                             cache: Optional[SubjectCache] = None):
    """Fixed-shape batch sampler: subjects drawn one at a time exactly as
    :func:`get_random_batch_ao` draws them, their windows pooled in FIFO
    order, batches of exactly ``batch_windows`` windows popped off."""
    buf_img: list = []
    buf_lab: list = []

    def next_batch():
        while len(buf_img) < batch_windows:
            images, labels = get_random_batch_ao(
                filename_list, 1, image_size=image_size,
                time_window=time_window, z_score=z_score, flatten=False,
                data_augmentation=data_augmentation, shift=shift,
                rotate=rotate, scale=scale, intensity=intensity, flip=flip,
                rng=rng, cache=cache)
            buf_img.extend(images)
            buf_lab.extend(labels)
        images = np.asarray(buf_img[:batch_windows], dtype=np.float32)
        labels = np.asarray(buf_lab[:batch_windows], dtype=np.int32)
        del buf_img[:batch_windows], buf_lab[:batch_windows]
        if flatten:
            images = images.reshape((-1,) + images.shape[2:])
            labels = labels.reshape((-1,) + labels.shape[2:])
        return {"image": images, "label": labels}

    return next_batch


def make_device_window_sampler(filename_list, batch_windows: int, pool,
                               image_size=256, time_window=1, z_score=True,
                               rng=None, cache: Optional[SubjectCache] = None,
                               verbose=False):
    """Index-batch sampler over a :class:`train.device_pool.DeviceCinePool`.

    Draws subjects with exactly :func:`make_window_pool_sampler`'s
    semantics (one ``randrange`` per subject, the same gates, the same
    circular windows around every annotated frame, FIFO window pooling)
    but makes the subject's cine device-resident and emits {"slot": (B,),
    "tidx": (B, TW), "lidx": (B, TW)} int32 batches for
    :func:`train.device_pool.make_pool_window_multi_step`.  ``lidx`` is
    the window itself when a propagated label exists, else the annotated
    centre frame repeated.  Per-subject window metadata is memoised by
    file key, so the steady state decodes nothing.  Every emitted window
    pins its slot; the consumer unpins each batch's slots once the step
    gathering them has been enqueued."""
    rng = rng or random
    n_file = len(filename_list)
    rad = (time_window - 1) // 2
    meta = {}  # key -> (t_anno tuple, T, has_prop)
    buf: list = []

    def draw():
        entry = filename_list[rng.randrange(n_file)]
        if not (os.path.exists(entry[0]) and os.path.exists(entry[1])):
            return
        key = _subject_key(entry, image_size, z_score)
        m = meta.get(key)
        first = None
        if m is None:
            # keep the decoded cine for the upload below: without a
            # SubjectCache a miss would otherwise decode twice
            first = _load_subject_ao(entry, image_size=image_size,
                                     z_score=z_score, cache=cache,
                                     verbose=verbose)
            if first is None:
                return
            image, label, label_prop = first
            t_anno = np.nonzero(np.sum(label > 0, axis=(0, 1, 2)))[0]
            if len(t_anno) == 0:
                print(f"Error: no annotated frame in {entry[1]}, skip.")
                meta[key] = ((), image.shape[3], False)
                return
            m = (tuple(int(t) for t in t_anno), image.shape[3],
                 label_prop is not None)
            meta[key] = m
        t_anno, T, has_prop = m
        if not t_anno:
            return

        def make_host(entry=entry, first=first):
            got = first if first is not None else _load_subject_ao(
                entry, image_size=image_size, z_score=z_score, cache=cache)
            if got is None:
                raise RuntimeError(f"subject {entry[0]} failed to re-load "
                                   "for pool upload")
            image, label, label_prop = got
            src = label_prop if label_prop is not None else label
            # (X, Y, 1, T) -> (T, X, Y); the pool stores f16 / uint8
            return (np.transpose(image[:, :, 0, :], (2, 0, 1)),
                    np.transpose(src[:, :, 0, :], (2, 0, 1)))

        slot = pool.ensure(key, make_host)
        for t in t_anno:
            idx = [(i + T) % T for i in range(t - rad, t + rad + 1)]
            lidx = idx if has_prop else [t] * time_window
            pool.pin(slot)
            buf.append((slot, idx, lidx))

    def next_batch():
        while len(buf) < batch_windows:
            draw()
        take = buf[:batch_windows]
        del buf[:batch_windows]
        return {"slot": np.asarray([s for s, _, _ in take], np.int32),
                "tidx": np.asarray([t for _, t, _ in take], np.int32),
                "lidx": np.asarray([li for _, _, li in take], np.int32)}

    return next_batch


def init_ao_model(cfg: AoTrainConfig,
                  generator: torch.Generator | None = None):
    """(ucfg, net, names) of the selected aortic model, Glorot-uniform
    from ``generator`` (``init_unet`` / ``init_biconv_lstm``; the draws
    are torch's): a 2D :class:`UNet`, a temporal one, or a
    :class:`UNetLSTM`.  ``names`` is the U-Net's layer-name structure."""
    n_filter = tuple(cfg.num_filter * (2 ** i) for i in range(cfg.num_level))
    ucfg = UNetConfig(n_class=cfg.n_class, n_level=cfg.num_level,
                      n_filter=n_filter, n_block=(2, 2, 2, 2, 2))
    temporal = cfg.model == "Temporal-UNet"
    unet = init_weights(UNet(ucfg, dims=3 if temporal else 2), generator)
    names = convert.unet_names(ucfg, temporal)
    if cfg.model != "UNet-LSTM":
        return ucfg, unet, names
    cls = convlstm.BiConvLSTM if cfg.bidirectional else convlstm.ConvLSTM
    lstm = init_weights(cls(n_filter[0], cfg.num_hidden, cfg.n_class),
                        generator)
    return ucfg, wrappers.UNetLSTM(unet, lstm), names


def make_ao_loss(cfg: AoTrainConfig, net: torch.nn.Module,
                 train: bool = True, device_augment: bool = False,
                 shift=0.0, rotate=10.0, scale=0.2, intensity=0.0,
                 flip=False, compute_dtype=None, group=None):
    """Loss closure per model kind (``train_network_ao.py:285-317``):
    ``loss_fn(batch, seed) -> (loss, aux)`` with accuracy and the AAo /
    DAo Dice of the centre frame.  ``train=False`` is the evaluation twin
    (BN moving statistics, the reference's ``training: False`` feed,
    :449); as in the JAX trainer a jointly trained UNet-LSTM's U-Net
    still normalises with batch statistics there, but its moving
    statistics are left as they were.

    ``device_augment``: the window-consistent affine runs on the device
    from a generator seeded with the step's ``seed`` (``loss_fn.draw`` and
    ``loss_fn.apply``, as ``train.sa.make_fcn_loss``); UNet batches then
    arrive grouped by window (N, T, X, Y, 1) and fold after it.
    ``group``: the process group of a data-parallel step, the batch this
    rank's equal shard of windows: global BatchNorm statistics,
    augmentation parameters and aux metrics (``train.sa.make_fcn_loss``).
    """
    dtype = compute_dtype or torch.float32
    generators = {}
    shard = steps_lib.group_shard(group)
    classes = [("dice_aa", 1), ("dice_da", 2)]

    def forward(images, labels):
        s = (cfg.time_window - 1) // 2
        if cfg.model == "UNet":
            if images.dim() == 5:  # window-grouped input
                images = images.flatten(0, 1)
                labels = labels.flatten(0, 1)
            loss, _, pred = wrappers.unet_model(net, images, labels, train,
                                                dtype)
            return loss, pred, labels
        if cfg.model == "Temporal-UNet":
            loss, _, pred = wrappers.temporal_unet_model(
                net, images, labels, train, cfg.weight_R, cfg.weight_r,
                dtype)
            return loss, pred[:, s], labels[:, s]
        kw = dict(train_unet=cfg.joint_train, seq2seq=cfg.seq2seq,
                  weight_R=cfg.weight_R, weight_r=cfg.weight_r,
                  compute_dtype=dtype)
        if cfg.joint_train and not train:
            saved = [b.clone() for b in net.unet.buffers()]
            loss, _, pred = wrappers.unet_lstm_model(net, images, labels,
                                                     **kw)
            with torch.no_grad():
                for b, v in zip(net.unet.buffers(), saved):
                    b.copy_(v)
        else:
            loss, _, pred = wrappers.unet_lstm_model(net, images, labels,
                                                     **kw)
        return loss, pred[:, s], labels[:, s]

    def draw(seed: int, n: int, device):
        gen = generators.get(device)
        if gen is None:
            gen = generators[device] = torch.Generator(device=device)
        gen.manual_seed(seed)
        return sample_shard_params(gen, n, shift, rotate, scale, intensity,
                                   device, shard)

    def apply(batch, draws):
        # compact batches (f16 image / uint8 label) are cast here
        images = batch["image"].float()
        labels = batch["label"].to(torch.int32)
        if draws is not None:
            images, labels = aortic_augment_with_params(images, labels,
                                                        draws, flip)
        with batch_norm_group(net, group):
            loss, pred_fr, label_fr = forward(images, labels)
        return loss, steps_lib.segmentation_aux(pred_fr, label_fr, classes,
                                                group)

    def loss_fn(batch, seed: int):
        images = batch["image"]
        return apply(batch, draw(seed, images.shape[0], images.device)
                     if device_augment else None)

    loss_fn.draw = draw if device_augment else None
    loss_fn.apply = apply
    return loss_fn


def make_ao_optimizer(cfg: AoTrainConfig, net: torch.nn.Module):
    """Adam with the optional lr decay (``train_network_ao.py:341-362``),
    over the LSTM's parameters only for a UNet-LSTM unless
    ``joint_train``."""
    frozen = cfg.model == "UNet-LSTM" and not cfg.joint_train
    params = net.lstm.parameters() if frozen else net.parameters()
    return steps_lib.adam_with_schedule(params, cfg.learning_rate,
                                        reduce_after=cfg.reduce_lr_after)


def restore_pretrained_unet(net: wrappers.UNetLSTM, model_path: str):
    """Load the U-Net (BN moving statistics included) from a bundle's
    ``UNet`` scope — the two-phase restore (``train_network_ao.py:
    407-414``).  A TF checkpoint prefix is converted first
    (``ckpt/tf_reader.py``; needs tensorflow on the host)."""
    if not model_path.endswith(".npz"):
        from ukbb_cardiac_tpu_torch.ckpt.tf_reader import \
            convert_tf_checkpoint
        model_path = convert_tf_checkpoint(model_path)
    _, _, names, params, state = store.load_model(model_path)
    sd = convert.unet_state_dict_from_jax(params, state, names)
    device = next(net.unet.parameters()).device
    net.unet.load_state_dict({k: v.to(device) for k, v in sd.items()})
    return net


def bundle_trees(net: torch.nn.Module, names):
    """The model's JAX-layout (params, state): the U-Net's ``UNet`` scope
    and, for a UNet-LSTM, the ``LSTM`` tree beside it."""
    unet = net.unet if isinstance(net, wrappers.UNetLSTM) else net
    params, state = convert.unet_to_jax(unet, names)
    if isinstance(net, wrappers.UNetLSTM):
        params.update(convert.convlstm_to_jax(net.lstm))
    return params, state


def _make_device_window_pipeline(cfg: AoTrainConfig, train_list, K, rng,
                                 cache, device, verbose: bool = True):
    """Size and build the device cine pool and its index sampler.

    ``t_max`` comes from a header-only scan of the training cines; the
    slot count fits ``pool_gb`` and is floored at one dispatch chunk's
    worst-case working set (every window of a K-step chunk from a
    distinct subject, plus the sampler's spill-over)."""
    from ukbb_cardiac_tpu_torch.train.device_pool import DeviceCinePool

    t_max = 0
    for entry in train_list:
        try:
            shape = nifti.read_shape(entry[0])
        except Exception:
            continue
        if len(shape) >= 4:
            t_max = max(t_max, int(shape[3]))
    if t_max <= 0:
        raise ValueError("device_windows: no readable 4D training cine")
    s = cfg.image_size
    bytes_per_slot = t_max * s * s * 3  # f16 image + uint8 label
    budget_slots = int(cfg.pool_gb * (1 << 30) / bytes_per_slot)
    # worst case pinned at once: the prefetch queue (depth K+1), the chunk
    # in flight and the one under construction
    min_slots = min(len(train_list), (2 * K + 2) * cfg.batch_windows + 4)
    n_slots = min(len(train_list), max(budget_slots, 1))
    if n_slots < min_slots:
        raise ValueError(
            f"device_windows: pool_gb={cfg.pool_gb} holds {n_slots} cines "
            f"({bytes_per_slot / 2 ** 20:.0f} MiB each) but one dispatch "
            f"chunk may pin {min_slots}; raise pool_gb or lower "
            "batch_windows/steps_per_dispatch")
    pool = DeviceCinePool(n_slots, t_max, s, s, device)
    if verbose:
        print(f"Device window pool: {n_slots} slots x T{t_max} @ {s}x{s} "
              f"({pool.nbytes / 2 ** 30:.2f} GiB)")
    sample = make_device_window_sampler(
        train_list, cfg.batch_windows, pool, image_size=cfg.image_size,
        time_window=cfg.time_window, z_score=cfg.z_score, rng=rng,
        cache=cache)
    return pool, sample


def _check_config(cfg: AoTrainConfig, K: int, world: int):
    if cfg.model not in KINDS:
        raise ValueError(f"unknown model {cfg.model!r}")
    if K > 1 and cfg.batch_windows <= 0:
        raise ValueError("steps_per_dispatch > 1 requires batch_windows "
                         "(a static batch shape to stack K batches)")
    if cfg.device_windows:
        if cfg.batch_windows <= 0:
            raise ValueError("device_windows requires batch_windows "
                             "(a static window batch to index-gather)")
        if not cfg.device_augment:
            raise ValueError("device_windows requires device_augment: the "
                             "windows never exist on the host, so the "
                             "affine augmentation must run in the step")
    if world > 1:
        if cfg.batch_windows <= 0:
            raise ValueError("mesh_devices > 1 requires batch_windows "
                             "(a static batch to shard evenly)")
        if cfg.batch_windows % world:
            raise ValueError("batch_windows must divide evenly over "
                             f"mesh_devices ({cfg.batch_windows} % "
                             f"{world} != 0)")


def train(cfg: AoTrainConfig, max_iterations: Optional[int] = None,
          progress_every: int = 100, *, devices=None,
          backend: Optional[str] = None):
    """Run the training loop.  Returns (net, names, ucfg, stats).

    ``stats``: iterations run, and from the end of the first call on
    (warm-up excluded) the step loop's seconds (validation and
    checkpoints excluded), the seconds it waited for the next chunk, and
    the steps it ran.  With ``mesh_devices`` > 1, or ``devices`` /
    ``backend`` (``train.sa.train``), the ranks run in processes of their
    own and the returned net and stats are rank 0's."""
    K = max(1, int(cfg.steps_per_dispatch))
    world = len(devices) if devices is not None else cfg.mesh_devices
    _check_config(cfg, K, world)
    device = resolve_device(cfg.device)
    if devices is None and cfg.mesh_devices <= 1:
        return _train(cfg, K, device, max_iterations, progress_every)
    from ukbb_cardiac_tpu_torch.train import distributed

    ranks = distributed.rank_devices(world, cfg.device, devices)
    sd, names, ucfg, stats = distributed.run(
        train_rank, (cfg, K, max_iterations, progress_every), ranks,
        backend)
    _, net, _ = init_ao_model(cfg)
    net.load_state_dict(sd)
    fmt = (torch.preserve_format if cfg.model == "Temporal-UNet"
           else torch.channels_last)
    return net.to(ranks[0], memory_format=fmt), names, ucfg, stats


def train_rank(rank, cfg: AoTrainConfig, K: int,
               max_iterations: Optional[int] = None,
               progress_every: int = 100):
    """One data-parallel rank's share of :func:`train` (as
    ``train.sa.train_rank``).  Returns the state dict on the CPU with the
    names, config and stats (``distributed.rank_stats``, with the peak
    memory of this job alone)."""
    from ukbb_cardiac_tpu_torch.train.distributed import rank_stats

    _check_config(cfg, K, rank.world)
    started = time.time()
    if rank.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(rank.device)
    net, names, ucfg, stats = _train(
        cfg, K, resolve_device(str(rank.device)), max_iterations,
        progress_every, rank)
    return ({k: v.cpu() for k, v in net.state_dict().items()}, names, ucfg,
            rank_stats(rank, stats, started))


def _train(cfg: AoTrainConfig, K: int, device, max_iterations,
           progress_every, rank=None):
    """The training loop on ``device``; in a data-parallel ``rank``
    (``distributed.Rank``) its share of it."""
    group = rank.group if rank is not None else None
    shard = (rank.rank, rank.world) if rank is not None else None
    lead = rank is None or rank.rank == 0
    data_list = scan_dataset_ao(cfg.dataset_dir, cfg.seq_name)
    if not data_list["train"]:
        raise FileNotFoundError(
            f"no training data under {cfg.dataset_dir}/train")

    ucfg, net, names = init_ao_model(
        cfg, torch.Generator().manual_seed(cfg.seed))
    if cfg.model == "UNet-LSTM" and not cfg.from_scratch:
        if not cfg.model_path:
            raise ValueError("UNet-LSTM needs --model_path (pre-trained "
                             "UNet) unless --from_scratch")
        if lead:
            print("Restore pre-trained UNet weights...")
        restore_pretrained_unet(net, cfg.model_path)
    # channels-last 2D convolutions skip cuDNN's layout transposes and
    # take PyTorch's channels-last BatchNorm kernels (train/sa.py)
    if cfg.model == "Temporal-UNet":
        net = net.to(device)
    else:
        net = net.to(device, memory_format=torch.channels_last)
    optimizer = make_ao_optimizer(cfg, net)
    loss_fn = make_ao_loss(cfg, net, device_augment=cfg.device_augment,
                           shift=0, rotate=10, scale=0.2, intensity=0,
                           flip=False,
                           compute_dtype=torch.bfloat16 if cfg.bf16 else None,
                           group=group)
    # the trainer's programs (train/steps.py), built after the restore and
    # the memory format; they read every parameter and state tensor by
    # address, and go at the end
    programs = ProgramCache(max_bytes=steps_lib.TRAINER_BYTES)
    # validation runs on rank 0 alone: its statistics are its own batch's
    eval_loss = make_ao_loss(cfg, net, train=False)
    eval_step = steps_lib.make_eval_step(lambda batch: eval_loss(batch, 0),
                                         programs=programs)
    step, multi_step = make_steps(loss_fn, optimizer, group, programs,
                                  cfg.device_windows, "window")

    model_dir = os.path.join(cfg.checkpoint_dir, cfg.model_name)
    if lead:
        os.makedirs(model_dir, exist_ok=True)
        log_f = open(os.path.join(model_dir, "train_log.jsonl"), "a")

    rng = random.Random(cfg.seed)
    # validation draws its own stream, so queue timing cannot change what
    # a fixed seed samples
    val_rng = random.Random(cfg.seed + 7_777_777)
    flatten = cfg.model == "UNet"
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
    # with device_augment, UNet batches stay window-grouped (N, T, ...) so
    # each window shares one transform; the loss folds T afterwards
    host_flatten = flatten and not cfg.device_augment
    pool = None
    if cfg.device_windows:
        pool, sample = _make_device_window_pipeline(
            cfg, data_list["train"], K, rng, cache, device, lead)
    elif cfg.batch_windows > 0:
        sample = make_window_pool_sampler(
            data_list["train"], cfg.batch_windows, image_size=cfg.image_size,
            time_window=cfg.time_window, z_score=cfg.z_score,
            flatten=host_flatten, data_augmentation=not cfg.device_augment,
            shift=0, rotate=10, scale=0.2, intensity=0, flip=False, rng=rng,
            cache=cache)
    else:
        def sample():
            images, labels = get_random_batch_ao(
                data_list["train"], cfg.train_batch_size,
                image_size=cfg.image_size, time_window=cfg.time_window,
                z_score=cfg.z_score, flatten=host_flatten,
                data_augmentation=not cfg.device_augment,
                shift=0, rotate=10, scale=0.2, intensity=0, flip=False,
                rng=rng, cache=cache)
            return {"image": images, "label": labels}

    if cfg.compact_transfer and not cfg.device_windows:
        def make_batch():
            b = sample()
            return {"image": b["image"].astype(np.float16),
                    "label": b["label"].astype(np.uint8)}
    else:
        make_batch = sample

    prefetcher = BatchPrefetcher(make_batch, depth=2 if K == 1 else K + 1)
    cadences = (cfg.validation_every, cfg.checkpoint_every, progress_every)
    stage = make_stage(device)
    if cfg.device_windows:
        build_input = make_pool_chunk_builder(prefetcher, pool, K, total,
                                              cadences, stage, shard)
    else:
        build_input = make_chunk_builder(prefetcher, K, total, cadences,
                                         stage, shard)

    def side_work(iteration, loss, aux, t0, k_now):
        if not lead:
            return
        if iteration % cfg.validation_every == 0:
            rec = {"iteration": iteration, "loss": float(loss),
                   "accuracy": float(aux["accuracy"]),
                   "dice_aa": float(aux["dice_aa"]),
                   "dice_da": float(aux["dice_da"]),
                   # per iteration, whatever K the call ran
                   "seconds": (time.time() - t0) / k_now}
            if data_list["validation"]:
                # held-out Dice AA/DA (train_network_ao.py:441-457)
                v_images, v_labels = get_random_batch_ao(
                    data_list["validation"], cfg.validation_batch_size,
                    image_size=cfg.image_size, time_window=cfg.time_window,
                    z_score=cfg.z_score, flatten=flatten,
                    data_augmentation=False, rng=val_rng, cache=cache)
                v_loss, v_aux = eval_step(
                    {"image": torch.from_numpy(v_images).to(device),
                     "label": torch.from_numpy(v_labels).to(device)})
                rec["val_loss"] = float(v_loss)
                rec["val_accuracy"] = float(v_aux["accuracy"])
                rec["val_dice_aa"] = float(v_aux["dice_aa"])
                rec["val_dice_da"] = float(v_aux["dice_da"])
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()

        if iteration % progress_every == 0:
            print(f"Iteration {iteration}/{total}: loss = {float(loss):.4f}")

        if iteration % cfg.checkpoint_every == 0 or iteration == total:
            params, state = bundle_trees(net, names)
            store.save_model(
                os.path.join(model_dir, f"model-{iteration}.npz"),
                KINDS[cfg.model], ucfg, names, params, state,
                extra_meta={"iteration": iteration,
                            "bidirectional": cfg.bidirectional})

    try:
        stats = run_chunks(build_input, step, multi_step, cfg.device_windows,
                           0, total, cadences, device, side_work)
        stats["programs"] = program_stats(programs)
        stats["route"] = multi_step.route
    finally:
        prefetcher.close()
        programs.clear()
        if lead:
            log_f.close()
    if lead:
        print(f"Training took {time.time() - start_time:.3f}s.")
    return net, names, ucfg, stats
