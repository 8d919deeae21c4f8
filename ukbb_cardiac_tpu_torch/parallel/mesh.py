"""Device meshes: whole subjects, slices and registration pairs split over
several devices.

Counterpart of ``ukbb_cardiac_tpu/parallel/mesh.py``.  The JAX package
hands a ``jax.sharding.Mesh`` to XLA, which partitions one program over
the chips.  Every mesh path of the package is embarrassingly parallel
(subjects, slices and registration pairs are independent), so here a mesh
is only a device array with axis names: a caller splits its batch along
an axis with :func:`shard_batch` (or :func:`split_leading`), runs each
shard on its device with :func:`map_shards`, and gathers the results.
One process drives every device; shards on distinct devices are issued
from a host thread each, shards that share a device run one after the
other on it.

A mesh may name one device several times (``make_mesh(["cpu"] * 8)``,
``make_mesh(["cuda:0", "cuda:0"])``): the split, the per-shard work and
the gather are then exercised on one device, and results equal the
unsharded run's.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ukbb_cardiac_tpu_torch import resolve_device


def canonical_device(device) -> torch.device:
    """``device`` as a torch device with its card's index (``"cuda"`` is
    the current card), so that two names of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device_for(device, mesh=None) -> torch.device:
    """The device a strain or cohort stage keeps its tensors on:
    ``device``, else the mesh's first device, else the card
    (:func:`resolve_device`)."""
    if device is None and mesh is not None:
        device = mesh.devices.flat[0]
    return resolve_device(None if device is None else str(device))


class Mesh:
    """An n-dimensional array of torch devices with axis names.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``
    does.  Meshes are hashable and compare by devices, shape and names."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat),
                self.devices.shape, self.axis_names)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"shape={self.shape})")

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """The device of each position along ``axis`` (the first device of
        the other axes at that position): where shard i of a batch split
        over ``axis`` runs."""
        k = self.axis_names.index(axis)
        return [np.take(self.devices, [i], axis=k).flat[0]
                for i in range(self.devices.shape[k])]


def make_mesh(n_devices=None, axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """A mesh over the first ``n_devices`` cards (default all of them).

    ``n_devices`` may instead be an explicit list of devices
    (``["cpu"] * 4``, ``["cuda:0", "cuda:0"]``).  ``device="cpu"`` gives
    ``n_devices`` CPU replicas.  Asking for more cards than the machine
    has raises ``ValueError``; a CUDA mesh without a card raises, it never
    becomes a CPU mesh.  ``shape``: per-axis sizes, by default every
    device on the first axis."""
    if isinstance(n_devices, (list, tuple)):
        devs = [canonical_device(resolve_device(str(d))) for d in n_devices]
        n_cards = torch.cuda.device_count()
        for d in devs:
            if d.type == "cuda" and (d.index or 0) >= n_cards:
                raise ValueError(f"{d} named, but the machine has {n_cards} "
                                 f"card(s)")
    elif device is not None and torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * (1 if n_devices is None else n_devices)
    else:
        resolve_device(device)
        n_cards = torch.cuda.device_count()
        n = n_cards if n_devices is None else n_devices
        if n > n_cards:
            raise ValueError(f"a mesh of {n} cards asked for, but the "
                             f"machine has {n_cards}")
        devs = [torch.device("cuda", i) for i in range(n)]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        shape = [len(devs)] + [1] * (len(axes) - 1)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(tuple(shape)), axes)


class Sharding(NamedTuple):
    """Where an array's dimensions go: ``spec[i]`` names the mesh axis
    that dimension i is split over (None or absent: not split).  The
    JAX package builds ``NamedSharding``s with these; nothing of it but
    its ``parallel/__init__.py`` uses them, so here they are plain
    descriptors that :func:`shard_batch` reads."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Split the leading (batch) axis over the mesh axis."""
    return Sharding(mesh, (axis,))


def spatial_sharding(mesh: Mesh, batch_axis: str = "data",
                     space_axis: str = "space") -> Sharding:
    """(N, X, Y, C) activations: batch over ``batch_axis``, X over
    ``space_axis``."""
    return Sharding(mesh, (batch_axis, space_axis))


def _place(x, sharding: Sharding) -> List[torch.Tensor]:
    """One block of ``x`` per mesh device (in the mesh's flat order), on
    that device."""
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    mesh = sharding.mesh
    sizes = mesh.shape
    for dim, axis in enumerate(sharding.spec):
        if axis is not None and x.shape[dim] % sizes[axis]:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                             f"not divide over mesh axis {axis!r} of size "
                             f"{sizes[axis]}")
    blocks = []
    for coord in np.ndindex(*mesh.devices.shape):
        index = []
        for dim, axis in enumerate(sharding.spec):
            if axis is None:
                index.append(slice(None))
                continue
            step = x.shape[dim] // sizes[axis]
            pos = coord[mesh.axis_names.index(axis)]
            index.append(slice(pos * step, (pos + 1) * step))
        blocks.append(x[tuple(index)].to(mesh.devices[coord]))
    return blocks


def shard_batch(batch, mesh, axis: str = "data"):
    """Place a host array (or a dict, list or tuple of them) with its
    leading axis split over ``axis`` of ``mesh``: each array becomes the
    list of its blocks, one per mesh device, each on its device.  The
    batch must divide the axis (as JAX's ``device_put`` requires).
    ``mesh`` may also be a :class:`Sharding` from :func:`replicated`,
    :func:`batch_sharding` or :func:`spatial_sharding`."""
    sh = mesh if isinstance(mesh, Sharding) else batch_sharding(mesh, axis)
    if isinstance(batch, dict):
        return {k: shard_batch(v, sh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, sh) for v in batch)
    return _place(batch, sh)


def pad_batch_to_devices(batch: np.ndarray, n: int):
    """Pad the leading axis up to a multiple of n (fleet-mode inference:
    ragged subject batches -> equal shards).  Returns (padded, valid)."""
    b = batch.shape[0]
    target = -(-b // n) * n
    if target == b:
        return batch, b
    pad = [(0, target - b)] + [(0, 0)] * (batch.ndim - 1)
    return np.pad(batch, pad), b


def cycle_to_multiple(x, n: int):
    """Pad the leading axis of an array or tensor up to a multiple of
    ``n`` by cycling its entries (so a batch smaller than ``n`` fills
    too).  Returns (padded, original count); raises on an empty batch."""
    S = x.shape[0]
    if S == 0:
        raise ValueError("empty batch: nothing to pad or cycle")
    pad_n = (-S) % n
    if not pad_n:
        return x, S
    reps = -(-pad_n // S)
    if torch.is_tensor(x):
        extra = torch.cat([x] * reps)[:pad_n]
        return torch.cat([x, extra]), S
    extra = np.concatenate([x] * reps, axis=0)[:pad_n]
    return np.concatenate([x, extra], axis=0), S


def split_leading(x, mesh: Mesh, axis: str = "data") -> list:
    """Split the leading axis of ``x`` into equal consecutive shards, one
    per position along ``axis``, left where they are (the caller moves
    each to its device).  Raises when the axis does not divide."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not divide over mesh "
                         f"axis {axis!r} of size {n}")
    k = x.shape[0] // n
    return [x[i * k:(i + 1) * k] for i in range(n)]


def map_shards(fn: Callable, shards: Sequence, devices: Sequence) -> list:
    """``[fn(shard, device) for shard, device in zip(shards, devices)]``,
    with the shards of each distinct device issued from a host thread of
    its own, so that one card's launches do not wait for another's, and
    with that card current while it runs.  Shards that share a device run
    one after the other, in order.  An exception in any shard is raised
    here; nothing falls back."""
    by_device = {}
    for i, d in enumerate(devices):
        by_device.setdefault(str(d), []).append(i)
    out = [None] * len(shards)

    def run(indices):
        for i in indices:
            d = torch.device(devices[i])
            # the shard's card is current: its streams and events are used
            with (torch.cuda.device(d) if d.type == "cuda"
                  else contextlib.nullcontext()):
                out[i] = fn(shards[i], devices[i])

    if len(by_device) == 1:
        run(range(len(shards)))
        return out
    errors = []

    def guarded(indices):
        try:
            run(indices)
        except BaseException as exc:  # re-raised on the calling thread
            errors.append(exc)

    threads = [threading.Thread(target=guarded, args=(ix,))
               for ix in by_device.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out
