"""Device-resident pool: train on slices or time windows gathered on the
card.

Counterpart of ``ukbb_cardiac_tpu/train/device_pool.py``.  Each
subject-frame volume (SA trainer) or normalised cine (aortic trainer)
goes to the device once, into a fixed slot of one (n_slots, t_max, X, Y)
float16 image pool and one uint8 label pool; a train step gathers its
(slot, z) index pairs or (slot, window frames, label frames) tuples from
the pool, so the steady-state host-to-device traffic is a few bytes of
indices per slice or window instead of its pixels.  In data-parallel
training (``train/distributed.py``) every rank holds a whole pool of its
own, filled by the same seeded sampler, and gathers its shard of each
(K, B[, TW]) index batch from it: the JAX package's pool replicated over
the mesh with the index batches sharded on B.

Ordering, without the JAX design's copy-on-upload (JAX needed a fresh
pool array per upload because donating the pool would invalidate the
arrays queued batches hold):

- an upload is an in-place ``copy_`` into its slot on the pool's stream,
  which is the stream the train steps run on (never a side stream), so
  it is ordered after every step enqueued before it;
- a slot stays pinned from the moment the sampler emits one of its
  slices until the step that gathers that slice has been enqueued, and
  eviction takes only an unpinned slot (LRU first).  So no upload into a
  slot can be enqueued before a step that still reads the slot's old
  volume.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch


class DeviceCinePool:
    """Fixed-slot device pool of (image f16, label uint8) volumes.

    ``ensure(key, make_host)`` returns the slot holding ``key``'s volume,
    uploading ``make_host() -> (img_zxy, lab_zxy)`` (arrays (Z, X, Y) with
    Z <= z_max, zero-padded here) on first touch.  ``pin`` / ``unpin``
    protect slots that emitted slices still waiting for their step.
    ``snapshot()`` returns the (img, lab) pool tensors.  Thread-safe: the
    trainer's prefetch worker ensures while the main loop steps.
    """

    def __init__(self, n_slots: int, t_max: int, x: int, y: int,
                 device="cpu", img_dtype=torch.float16):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = int(n_slots)
        self.t_max = int(t_max)
        self.shape_xy = (int(x), int(y))
        self.device = torch.device(device)
        self._img = torch.zeros((n_slots, t_max, x, y), dtype=img_dtype,
                                device=self.device)
        self._lab = torch.zeros((n_slots, t_max, x, y), dtype=torch.uint8,
                                device=self.device)
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        self._slot_of = collections.OrderedDict()  # key -> slot, LRU order
        self._key_of = {}                          # slot -> key
        self._pins = collections.Counter()         # slot -> refcount
        self._free = list(range(n_slots - 1, -1, -1))
        self._lock = threading.Lock()
        self.uploads = 0
        self.hits = 0

    @property
    def nbytes(self) -> int:
        return (self._img.numel() * self._img.element_size()
                + self._lab.numel())

    def snapshot(self):
        return self._img, self._lab

    def pin(self, slot: int, n: int = 1):
        with self._lock:
            self._pins[slot] += n

    def unpin(self, slot: int, n: int = 1):
        with self._lock:
            self._pins[slot] -= n
            if self._pins[slot] <= 0:
                del self._pins[slot]

    def _upload(self, slot: int, img: np.ndarray, lab: np.ndarray):
        host_img, host_lab = torch.from_numpy(img), torch.from_numpy(lab)
        if self.stream is None:
            self._img[slot].copy_(host_img)
            self._lab[slot].copy_(host_lab)
            return
        with torch.cuda.stream(self.stream):
            self._img[slot].copy_(host_img.pin_memory(), non_blocking=True)
            self._lab[slot].copy_(host_lab.pin_memory(), non_blocking=True)

    def ensure(self, key, make_host) -> int:
        """Slot of ``key``'s volume, uploading on first touch (LRU evict)."""
        with self._lock:
            slot = self._slot_of.get(key)
            if slot is not None:
                self._slot_of.move_to_end(key)
                self.hits += 1
                return slot
        # host decode outside the lock (gzip inflate can be slow)
        img, lab = make_host()
        t = img.shape[0]
        if t > self.t_max or img.shape[1:] != self.shape_xy:
            raise ValueError(
                f"volume shape {img.shape} exceeds pool slot "
                f"({self.t_max}, {self.shape_xy}) — rebuild the pool")
        if t < self.t_max:
            pad = ((0, self.t_max - t), (0, 0), (0, 0))
            img = np.pad(img, pad)
            lab = np.pad(lab, pad)
        img = np.ascontiguousarray(img, np.float16)
        lab = np.ascontiguousarray(lab, np.uint8)
        with self._lock:
            slot = self._slot_of.get(key)
            if slot is not None:  # raced with another thread's upload
                self._slot_of.move_to_end(key)
                return slot
            if self._free:
                slot = self._free.pop()
            else:
                slot = None
                for k, s in self._slot_of.items():  # LRU-first order
                    if s not in self._pins:
                        slot = s
                        del self._slot_of[k]
                        del self._key_of[s]
                        break
                if slot is None:
                    raise RuntimeError(
                        "DeviceCinePool: every slot is pinned by queued "
                        "batches — the pool cannot hold one dispatch "
                        "chunk's working set.  Increase pool_gb, or "
                        "reduce the batch size or steps_per_dispatch.")
            self._upload(slot, img, lab)
            self._slot_of[key] = slot
            self._key_of[slot] = key
            self.uploads += 1
            return slot


def _gather_slices(flat_img, flat_lab, ib, t_max):
    """(slot, z) index pairs of any shape S -> {"image": S + (X, Y, 1) f16,
    "label": S + (X, Y) uint8}."""
    fi = ib["slot"].long() * t_max + ib["zidx"].long()
    return {"image": flat_img[fi][..., None], "label": flat_lab[fi]}


def _gather_windows(flat_img, flat_lab, ib, t_max):
    """(slot, tidx, lidx) of leading shape S -> {"image": S + (TW, X, Y,
    1) f16, "label": S + (TW, X, Y) uint8}.  ``tidx`` are the circular
    window frames, ``lidx`` the label frames: the window itself when a
    densely propagated label exists, the annotated centre repeated
    otherwise (``train_network_ao.py:181-187``)."""
    base = ib["slot"].long()[..., None] * t_max
    return {"image": flat_img[base + ib["tidx"].long()][..., None],
            "label": flat_lab[base + ib["lidx"].long()]}


def _make_pool_multi_step(loss_fn, optimizer, gather, group=None,
                          programs=None):
    """The one K-step body the four pool steps share:
    ``steps.make_multi_train_step``'s (``make_multi_dp_train_step``'s in
    a rank of ``group``), each step's batch gathered by index from the
    pool inside the call.  The variants differ only in the gather and
    the group.  On the card the call is one program that reads the pool
    by address (its key holds the pool's addresses): only the (K, B[,
    TW]) indices and the augmentation's draws are copied in, never the
    pool, whose in-place uploads on the step's stream are ordered before
    the replay."""
    from ukbb_cardiac_tpu_torch.train import steps

    def gather_batch(pool, batch):
        pool_img, pool_lab = pool
        n_slots, t_max = pool_img.shape[:2]
        flat_img = pool_img.reshape((n_slots * t_max,) + pool_img.shape[2:])
        flat_lab = pool_lab.reshape((n_slots * t_max,) + pool_lab.shape[2:])
        return gather(flat_img, flat_lab, batch, t_max)

    body = steps._Steps(loss_fn, optimizer, group, programs, gather_batch)

    def multi_step(pool_img, pool_lab, batches, seeds):
        return body(batches, seeds, pool=(pool_img, pool_lab))

    multi_step.programs, multi_step.route = body.programs, body.route
    return multi_step


def make_pool_slice_multi_step(loss_fn, optimizer: torch.optim.Optimizer, *,
                               programs=None):
    """K steps per call whose batches are (slot, z) index pairs gathered
    from the pool on the device.

    ``batches``: {"slot": (K, B) int32, "zidx": (K, B) int32} on the
    device.  The gather builds the exact {"image": (K, B, X, Y, 1) f16,
    "label": (K, B, X, Y) uint8} batches the host slice-pool sampler
    would have shipped with ``compact_transfer``, so ``loss_fn``
    (``train.sa.make_fcn_loss``) and ``steps.make_multi_train_step`` are
    reused unchanged.  Returns ``step(pool_img, pool_lab, batches, seeds)
    -> (losses[K], last_aux)``; release the batches' pins only after this
    returns.  ``programs``: as ``steps.make_multi_train_step``."""
    return _make_pool_multi_step(loss_fn, optimizer, _gather_slices,
                                 programs=programs)


def make_pool_slice_multi_dp_step(loss_fn, optimizer: torch.optim.Optimizer,
                                  group, *, programs=None):
    """Data-parallel :func:`make_pool_slice_multi_step` in one rank of
    ``group``: ``pool_img`` / ``pool_lab`` are this rank's own pool
    (every rank holds every drawn volume, in its own slots) and
    ``batches`` this rank's shard (K, B / world) of the index batches; the
    step is ``steps.make_multi_dp_train_step``'s (``loss_fn`` built for
    ``group``)."""
    return _make_pool_multi_step(loss_fn, optimizer, _gather_slices, group,
                                 programs)


def make_pool_window_multi_step(loss_fn, optimizer: torch.optim.Optimizer,
                                *, programs=None):
    """K steps per call whose batches are (slot, frame-index) tuples
    gathered from the pool on the device — the aortic twin of
    :func:`make_pool_slice_multi_step`.

    ``batches``: {"slot": (K, B) int32, "tidx": (K, B, TW) int32,
    "lidx": (K, B, TW) int32} (see :func:`_gather_windows`).  The gather
    builds the exact {"image": (K, B, TW, X, Y, 1) f16, "label": (K, B,
    TW, X, Y) uint8} batches the host window samplers would have shipped
    with ``compact_transfer``, so ``loss_fn`` (``train.ao.make_ao_loss``)
    is reused unchanged."""
    return _make_pool_multi_step(loss_fn, optimizer, _gather_windows,
                                 programs=programs)


def make_pool_window_multi_dp_step(loss_fn,
                                   optimizer: torch.optim.Optimizer, group,
                                   *, programs=None):
    """Data-parallel :func:`make_pool_window_multi_step`: this rank's own
    pool, its shard of the (K, B, TW) index batches on B — the aortic
    twin of :func:`make_pool_slice_multi_dp_step`."""
    return _make_pool_multi_step(loss_fn, optimizer, _gather_windows, group,
                                 programs)
