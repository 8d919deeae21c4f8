"""Batched segmentation inference engine.

Counterpart of ``ukbb_cardiac_tpu/infer/engine.py``.  A whole cine's Z*T
slices go through the network in chunks on the device, and only
2-bit-packed labels come back to the host:

  raw cine upload -> prep (percentile rescale, centred pad to a multiple
  of 16, (T, Z) frame-major slices padded to whole chunks) -> per chunk,
  the chunk forward (FCN encoder, fused CUDA head, uint8 argmax) -> pack
  (crop into the NIfTI file's voxel order, x fastest; bit pack, low field
  first) -> non-blocking copy into pinned host memory.  The host reads
  the labels back as a Fortran-ordered (X, Y, Z, T) view of the unpacked
  buffer, which ``io/nifti.py::save`` writes without a reorder.

On the card prep, the chunk forward and pack are the JAX engine's three
programs (``_cine_fns``' ``prep`` and ``pack``, and ``_fn``, keyed by the
padded chunk shape so that cines whose Z/T differ share it): CUDA graphs
captured at a shape's first call and replayed after
(``reg/programs.py``), in a cache the engine owns, over its own weights.
:meth:`InferenceEngine.segment_sequence_dispatch` returns as soon as that
work is queued; :meth:`PendingSegmentation.result` waits for it and
unpacks.  The cine goes up raw (:func:`upload_cine`); the upload and the
readback are :func:`dispatch_cine`, which the aortic engine's dispatch
calls too.

:meth:`InferenceEngine.segment_sequence_fused` is the same pipeline
waited for, with the rescale chosen ('percentile', 'zscore' or 'none').
The ResNet-FCN deploys as the FCN does: it shares the head, so the same
folded weights and head kernel serve it.

The same engine runs a 2D U-Net (``SegmentationModel.from_unet``, the
aortic deploy's ``'unet'`` kind) over normalised slices, with the softmax
probabilities on request (``want_prob``).

TransUNet (``SegmentationModel.from_transunet``) fixes its input grid:
its position embeddings are learned for ``img_size`` squared.  A model
with a ``grid`` makes the engine pad every cine, centred, to that grid
instead of to a multiple of ``pad_factor``, and refuse a larger matrix
with ``ValueError``; so every cine shape shares one chunk-forward
program.
"""

from __future__ import annotations

import copy
import functools
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ukbb_cardiac_tpu_torch import native
from ukbb_cardiac_tpu_torch.models.fcn import FCN, nchw
from ukbb_cardiac_tpu_torch.models.fused_head import (HeadWeights,
                                                      apply_fcn_fused,
                                                      fold_head)
from ukbb_cardiac_tpu_torch.models.transunet import TransUNet, fold_weight_std
from ukbb_cardiac_tpu_torch.models.unet import UNet
from ukbb_cardiac_tpu_torch.ops.crop import pad_to_multiple, pad_to_size
from ukbb_cardiac_tpu_torch.ops.intensity import (normalise_intensity_torch,
                                                  rescale_intensity_torch)
from ukbb_cardiac_tpu_torch.parallel.mesh import (canonical_device,
                                                  cycle_to_multiple,
                                                  map_shards, split_leading)
from ukbb_cardiac_tpu_torch.reg import programs
from ukbb_cardiac_tpu_torch.utils.timing import span


def unpack_bits(packed: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Unpack ``bits``-wide fields (low field first) from a uint8 byte
    array into ``n`` uint8 values — the host-side inverse of
    :func:`pack_bits`, in numpy: the plain version of the readback's
    ``native.unpack_bits``."""
    if bits not in (1, 2, 4):
        raise ValueError(f"bits must be 1, 2 or 4, got {bits}")
    packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    per = 8 // bits
    if n > packed.size * per:
        raise ValueError(f"{packed.size} packed bytes hold at most "
                         f"{packed.size * per} values, asked for {n}")
    shifts = np.arange(per, dtype=np.uint8) * bits
    mask = (1 << bits) - 1
    unpacked = (packed[:, None] >> shifts) & mask
    return unpacked.reshape(-1)[:n].astype(np.uint8)


def label_bits(n_class: int) -> int:
    """The field width of a packed label of ``n_class`` classes: 2, 4 or 8
    bits (the JAX engines' rule)."""
    return 2 if n_class <= 4 else (4 if n_class <= 16 else 8)


def pack_bits(flat: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint8 labels ``bits`` to a field, ``8 // bits`` per byte, the
    low field first (value i of a byte shifted by ``i * bits``) — the
    JAX engine's byte layout."""
    per = 8 // bits
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shifts = torch.arange(per, dtype=torch.int32, device=flat.device) * bits
    return (flat.view(-1, per).to(torch.int32) << shifts).sum(
        dim=1).to(torch.uint8)


@dataclass
class SegmentationModel:
    """A deployable slice-segmentation model on one device: the FCN (or
    ResNet-FCN) and its folded head weights, a 2D U-Net (``head``
    None), or a TransUNet with its weight standardisation folded
    (``head`` None, ``grid`` its fixed input size).
    :meth:`forward` maps (N, X, Y, C) images to channels-first float32
    logits (N, n_class, X, Y), eagerly (the engines' programs capture it,
    over weights that do not change; the trainer's validation is a
    program of its own that folds and packs the head on the card at
    every call, ``train/sa.py::validation_predict``)."""

    net: FCN | UNet | TransUNet
    head: HeadWeights | None
    compute_dtype: torch.dtype
    n_class: int
    grid: int | None = None

    @staticmethod
    def from_fcn(net: FCN, device,
                 compute_dtype=torch.float32) -> "SegmentationModel":
        net = net.to(device).eval()
        return SegmentationModel(net, fold_head(net), compute_dtype,
                                 net.cfg.n_class)

    from_resnet = from_fcn  # a ResNetFCN shares the FCN's head

    @staticmethod
    def from_unet(net: UNet, device,
                  compute_dtype=torch.float32) -> "SegmentationModel":
        net = net.to(device).eval()
        return SegmentationModel(net, None, compute_dtype, net.cfg.n_class)

    @staticmethod
    def from_transunet(net: TransUNet, device,
                       compute_dtype=torch.float32) -> "SegmentationModel":
        """The TransUNet on ``device``, its weight standardisation folded
        there (``models/transunet.py::fold_weight_std``)."""
        net = fold_weight_std(net.to(device).eval())
        return SegmentationModel(net, None, compute_dtype, net.cfg.n_class,
                                 net.cfg.img_size)

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def to(self, device) -> "SegmentationModel":
        """This model on ``device``: itself when it is there already, else
        a copy of the network there with its head (or its weight
        standardisation) folded again."""
        device = torch.device(device)
        if device == self.device:
            return self
        net = copy.deepcopy(self.net).to(device).eval()
        if isinstance(net, TransUNet):
            return SegmentationModel.from_transunet(net, device,
                                                    self.compute_dtype)
        return SegmentationModel(net, fold_head(net) if self.head is not None
                                 else None, self.compute_dtype, self.n_class)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if isinstance(self.net, TransUNet):
            return self.net(nchw(images, torch.float32), self.compute_dtype)
        if self.head is None:
            return self.net(nchw(images, self.compute_dtype))[0]
        return apply_fcn_fused(self.net, images, self.head,
                               self.compute_dtype)


class PendingSegmentation:
    """Handle for a cine segmentation still in flight.

    On the card the packed labels are being copied into pinned host
    memory behind an event; ``result()`` waits on that event and unpacks
    to (X, Y, Z, T) uint8 labels, Fortran-contiguous: every producer
    (:func:`_pack_cine`, ``deploy_ao._subject_pack``) packs them in the
    NIfTI file's voxel order, x fastest, so the unpacked buffer is the
    file's voxel stream and its reshape copies nothing.  ``device_ms``
    is then the time on the stream from the cine's upload to the end of
    the readback (CUDA events), or None on the CPU.  ``result()`` runs
    inside the profiler span ``ukbb.engine.wait`` (``utils/timing.py``),
    which times the wait on the profiler's clock.
    """

    def __init__(self, packed_host: torch.Tensor, out_shape, bits: int,
                 events=None):
        self._packed = packed_host
        self._shape = tuple(out_shape)
        self._bits = bits
        self._events = events
        self.device_ms = None

    @span("ukbb.engine.wait")
    def result(self) -> np.ndarray:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
        n = int(np.prod(self._shape))
        # one native pass through a per-byte table (the JAX engine's);
        # the numpy unpack builds a (bytes, 8 / bits) temporary
        return native.unpack_bits(self._packed.numpy(), self._bits,
                                  n).reshape(self._shape, order="F")


# the host dtypes a cine goes up in; uint16 and wider types go up as
# float32 (exact for 16-bit values), as the JAX engines ship them
_HOST_DTYPES = (np.float32, np.int16, np.uint8, np.int8, np.int32)


def upload_cine(image: np.ndarray, device, start=None) -> torch.Tensor:
    """The up-leg of a raw (X, Y, Z, T) cine: its transpose (T, Z, Y, X)
    as a contiguous tensor on ``device``, in the cine's own dtype when
    that is one of ``_HOST_DTYPES``, else float32.  For a Fortran-ordered
    NIfTI cine the transpose is the contiguous view, so the host copies
    nothing.  ``start``, a CUDA event, is recorded just before the
    upload."""
    image = np.asarray(image)
    if image.dtype not in _HOST_DTYPES:
        image = image.astype(np.float32)
    # the view may be read-only (NIfTI bytes); nothing writes to it
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable")
        host = torch.from_numpy(np.ascontiguousarray(image.T))
    if start is not None:
        start.record()
    return host.to(device)


def dispatch_cine(image: np.ndarray, device: torch.device, bits: int,
                  run) -> PendingSegmentation:
    """One cine through the device, not waited for: the upload
    (:func:`upload_cine`), ``run`` (the engine's programs, the uploaded
    (T, Z, Y, X) cine -> its labels packed ``bits`` to a field in the
    NIfTI file's voxel order) and, on the card, a non-blocking copy of
    the packed labels into pinned host memory, bracketed by two CUDA
    events.  The upload stays outside the programs (a pageable copy)."""
    events = None
    if device.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    packed = run(upload_cine(image, device,
                             start=None if events is None else events[0]))
    if events is not None:
        host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        events[1].record()
    else:
        host = packed
    return PendingSegmentation(host, np.shape(image), bits, events)


def pad_stack_to_multiple(stack: np.ndarray, n: int):
    """Pad a leading subject axis up to a multiple of ``n`` by cycling the
    subjects (so a stack smaller than ``n`` fills too).  Returns (padded,
    original count); raises on an empty stack."""
    return cycle_to_multiple(np.asarray(stack), n)


def pad_to_factor(X: int, Y: int, factor: int = 16):
    """Centred padding amounts ((x_pre, x_post), (y_pre, y_post)) that make
    X, Y multiples of ``factor`` (``deploy_network.py:97-100``), from
    :func:`~ukbb_cardiac_tpu_torch.ops.crop.pad_to_multiple`."""
    x_pre, x_post, y_pre, y_post = pad_to_multiple(X, Y, factor)
    return (x_pre, x_post), (y_pre, y_post)


def _chunk_forward(model: SegmentationModel, want_prob: bool,
                   images: torch.Tensor):
    """The JAX engine's ``_fn``: one chunk of (chunk, X, Y, C) padded
    slices -> (uint8 argmax labels (chunk, X, Y),) and, with
    ``want_prob``, the softmax probabilities (chunk, X, Y, n_class)."""
    logits = model.forward(images)
    pred = torch.argmax(logits, dim=1).to(torch.uint8)
    if want_prob:
        return pred, torch.softmax(logits, dim=1).permute(0, 2, 3, 1)
    return (pred,)


def _prep_cine(rescale: str, pads, n_pad: int, cine: torch.Tensor):
    """The JAX engine's ``prep``: the uploaded (T, Z, Y, X) cine in its own
    dtype -> rescaled (``'percentile'``, ``'zscore'`` or ``'none'``),
    centred-padded (T*Z + ``n_pad``, X', Y', 1) float32 slices, frame
    major, the last ``n_pad`` zero so that the chunks are whole."""
    if rescale == "percentile":
        cine = rescale_intensity_torch(cine, (1.0, 99.0))
    elif rescale == "zscore":
        cine = normalise_intensity_torch(cine)
    else:
        cine = cine.float()
    T, Z, Y, X = cine.shape
    x_pre, x_post, y_pre, y_post = pads
    slices = cine.transpose(2, 3).reshape(T * Z, X, Y)
    slices = F.pad(slices, (y_pre, y_post, x_pre, x_post, 0, n_pad))
    return (slices[..., None],)


def _pack_cine(shape, pads, bits: int, preds: torch.Tensor):
    """The JAX engine's ``pack``: padded (n, X', Y') labels, frame major
    -> the (X, Y, Z, T) cine's labels cropped and packed ``bits`` to a
    field, in the NIfTI file's voxel order ((T, Z, Y, X) C order, x
    fastest; the JAX engine packs (X, Y, Z, T) C order)."""
    X, Y, Z, T = shape
    x_pre, _, y_pre, _ = pads
    seg = preds[:T * Z, x_pre:x_pre + X, y_pre:y_pre + Y]
    seg = seg.reshape(T, Z, X, Y).transpose(2, 3).reshape(-1)
    return (pack_bits(seg, bits),)


class InferenceEngine:
    """Chunked slice segmentation on the model's device.

    ``chunk``: slices per forward (64 keeps the encoder's activations of
    a 192x208 chunk near 1 GB in float32).  ``pad_factor``: spatial
    padding multiple (16 = the FCN's 2^(n_level-1)); a model with a
    fixed ``grid`` is padded to that grid instead (:meth:`pads`).

    The engine owns its programs (the JAX engine's ``self._compiled``):
    the chunk forward keyed by the padded chunk shape and ``want_prob``,
    the dispatch's prep keyed by the cine's shape, dtype and rescale mode
    and its pack by the cine's shape, each a CUDA graph over this
    engine's weights on the card (``reg/programs.py``; the last chunk is
    padded up to a whole one, as the JAX engine pads it).  Each graph
    keeps a memory pool (a (192, 208, 10, 50) cine's prep and pack 0.86
    GiB on an NVIDIA H100 80GB HBM3, 700.00 W), so the programs are
    bounded by ``reg.programs.ENGINE_BYTES``, the least recently used
    dropped first; :meth:`release_programs` lets them go at once.

    The sharded paths (:meth:`make_sharded_forward`,
    :meth:`segment_subjects_sharded`) split their batch over a
    :class:`~ukbb_cardiac_tpu_torch.parallel.mesh.Mesh` and run each shard
    through this engine's own path on a replica on the shard's device
    (:meth:`replica`; on this engine's device, this engine), so their
    labels are those of :meth:`run_slices` and
    :meth:`segment_sequence_fused`.
    """

    def __init__(self, model: SegmentationModel, chunk: int = 64,
                 pad_factor: int = 16):
        self.model = model
        self.chunk = chunk
        self.pad_factor = pad_factor
        self.device = model.device
        # this engine's programs; nothing in them refers back to the
        # engine, so they go with it
        self._programs = programs.ProgramCache(
            max_bytes=programs.ENGINE_BYTES)
        self._replicas = {}

    def replica(self, device) -> "InferenceEngine":
        """The engine on ``device``: this one, or a copy of its model there
        (made at first use and kept, with programs of its own)."""
        key = str(canonical_device(device))
        if key == str(canonical_device(self.device)):
            return self
        if key not in self._replicas:
            self._replicas[key] = InferenceEngine(
                self.model.to(device), self.chunk, self.pad_factor)
        return self._replicas[key]

    def programs(self):
        """This engine's captured programs, least recently used first."""
        return self._programs.programs()

    def release_programs(self) -> None:
        """Drop this engine's programs and its replicas', and return their
        graphs' memory to the card (the caller that built the engine for
        one run, when the run ends); later calls capture again."""
        for rep in self._replicas.values():
            rep.release_programs()
        self._programs.clear()

    def pads(self, X: int, Y: int):
        """Centred padding (x_pre, x_post, y_pre, y_post) of an X x Y
        slice: to the model's fixed grid, or to multiples of
        ``pad_factor``.  A slice larger than the grid raises
        ``ValueError``."""
        grid = self.model.grid
        if grid is None:
            return pad_to_multiple(X, Y, self.pad_factor)
        if X > grid or Y > grid:
            raise ValueError(f"a {X} x {Y} matrix does not fit the model's "
                             f"{grid} x {grid} grid")
        return pad_to_size(X, Y, grid)

    def _labels(self, x: torch.Tensor, chunk: int, want_prob: bool = False):
        """(N, X, Y, C) padded float32 slices, N a multiple of ``chunk`` ->
        (N, X, Y) uint8 argmax, one chunk-forward program per chunk, each
        writing its slice of the outputs; with ``want_prob`` also the
        softmax probabilities (N, X, Y, n_class)."""
        fn = functools.partial(_chunk_forward, self.model, want_prob)
        outs = (torch.empty(x.shape[:3], dtype=torch.uint8, device=x.device),)
        if want_prob:
            outs += (torch.empty(x.shape[:3] + (self.model.n_class,),
                                 device=x.device),)
        for i in range(0, x.shape[0], chunk):
            self._programs.run(("chunk-forward", want_prob), fn,
                               x[i:i + chunk],
                               out=[o[i:i + chunk] for o in outs])
        return outs

    @torch.inference_mode()
    def run_slices(self, slices: np.ndarray, want_prob: bool = False):
        """Segment a stack of intensity-normalised 2D slices (N, X, Y) or
        (N, X, Y, C).  Padding and cropping are handled here.  Returns
        pred (N, X, Y) uint8, and with ``want_prob`` also the softmax
        probabilities (N, X, Y, n_class) float32."""
        slices = np.asarray(slices, dtype=np.float32)
        if slices.ndim == 3:
            slices = slices[..., None]
        N, X, Y = slices.shape[:3]
        x_pre, x_post, y_pre, y_post = self.pads(X, Y)
        chunk = self._chunk(N)
        x = torch.from_numpy(np.ascontiguousarray(slices)).to(self.device)
        x = F.pad(x, (0, 0, y_pre, y_post, x_pre, x_post, 0, -N % chunk))
        window = (slice(0, N), slice(x_pre, x_pre + X),
                  slice(y_pre, y_pre + Y))
        out = [o[window].cpu().numpy()
               for o in self._labels(x, chunk, want_prob)]
        return tuple(out) if want_prob else out[0]

    def _chunk(self, n: int) -> int:
        """Slices per forward for ``n`` slices: ``chunk``, or for fewer
        the next multiple of 8 (a short cine is not padded up to a whole
        chunk)."""
        return min(self.chunk, -(-n // 8) * 8)

    def segment_sequence(self, image: np.ndarray, want_prob: bool = False):
        """Segment a 4D cine (X, Y, Z, T) of normalised intensities in one
        batched pass.  Returns seg (X, Y, Z, T) uint8, and with
        ``want_prob`` also prob (X, Y, Z, T, n_class)."""
        X, Y, Z, T = image.shape
        # (X, Y, Z, T) -> (T*Z, X, Y): frame-major order t, then slice z
        slices = np.transpose(image, (3, 2, 0, 1)).reshape(T * Z, X, Y)
        out = self.run_slices(slices, want_prob)
        pred = out[0] if want_prob else out
        seg = np.transpose(pred.reshape(T, Z, X, Y), (2, 3, 1, 0))
        if want_prob:
            prob = np.transpose(out[1].reshape(T, Z, X, Y, -1),
                                (2, 3, 1, 0, 4))
            return seg, prob
        return seg

    def segment_volume(self, volume: np.ndarray, want_prob: bool = False):
        """Segment a 3D volume (X, Y, Z) slice-wise. Returns (X, Y, Z), and
        with ``want_prob`` also prob (X, Y, Z, n_class)."""
        out = self.run_slices(np.transpose(volume, (2, 0, 1)), want_prob)
        if want_prob:
            return (np.transpose(out[0], (1, 2, 0)),
                    np.transpose(out[1], (1, 2, 0, 3)))
        return np.transpose(out, (1, 2, 0))

    def segment_sequence_fused(self, image: np.ndarray,
                               rescale: str = "percentile") -> np.ndarray:
        """Rescale + segment a raw cine (X, Y, Z, T) as one device
        pipeline and wait for it.  ``rescale``: 'percentile'
        (``deploy_network.py:89``), 'zscore' (``deploy_network_ao.py:94``)
        or 'none' (already normalised).  Returns seg (X, Y, Z, T)
        uint8."""
        return self.segment_sequence_dispatch(image, rescale).result()

    @span("ukbb.engine.dispatch")
    @torch.inference_mode()
    def segment_sequence_dispatch(self, image: np.ndarray,
                                  rescale: str = "percentile"
                                  ) -> PendingSegmentation:
        """Queue the whole deploy pipeline of a raw cine (X, Y, Z, T) on
        the device — rescale (percentile by default,
        ``deploy_network.py:89``), pad, chunked forward, argmax, crop,
        2-bit pack, readback — and return a :class:`PendingSegmentation`
        without waiting for it."""
        if rescale not in ("percentile", "zscore", "none"):
            raise ValueError(f"unknown rescale {rescale!r}")
        X, Y, Z, T = np.shape(image)
        N = T * Z
        pads = self.pads(X, Y)
        chunk = self._chunk(N)
        bits = label_bits(self.model.n_class)

        def run(cine):
            (slices,) = self._programs.run(
                ("prep", rescale), functools.partial(
                    _prep_cine, rescale, pads, -N % chunk), cine)
            (preds,) = self._labels(slices, chunk)
            (packed,) = self._programs.run(
                ("pack", X, Y, Z, T),
                functools.partial(_pack_cine, (X, Y, Z, T), pads, bits),
                preds)
            return packed

        return dispatch_cine(image, self.device, bits, run)

    def make_sharded_forward(self, mesh, axis: str = "data"):
        """A slice forward with the batch split over ``axis`` of ``mesh``:
        ``run(images)`` maps (N, X, Y, 1) normalised slices to (N, X, Y)
        uint8 labels, N divided over the axis, each shard through
        :meth:`run_slices` of the replica on its device."""
        devices = mesh.axis_devices(axis)
        for d in devices:  # here, not in the shards' threads
            self.replica(d)

        def run(images):
            shards = split_leading(np.asarray(images), mesh, axis)
            return np.concatenate(map_shards(
                lambda s, d: self.replica(d).run_slices(s), shards, devices))

        return run

    def make_sharded_cine_forward(self, mesh, cine_shape,
                                  rescale: str = "percentile",
                                  axis: str = "data"):
        """Fleet inference of S raw cines of shape ``cine_shape`` (X, Y, Z,
        T): ``run(cines)`` maps (S, X, Y, Z, T) to (S, X, Y, Z, T) uint8
        labels with whole subjects split over ``axis`` (S must divide it).
        Each replica runs the per-subject pipeline of
        :meth:`segment_sequence_dispatch` (rescale, pad, chunked forward,
        argmax, pack, readback) on its device, every subject of its shard
        queued before the first is waited for."""
        if rescale not in ("percentile", "zscore", "none"):
            raise ValueError(f"unknown rescale {rescale!r}")
        cine_shape = tuple(cine_shape)
        devices = mesh.axis_devices(axis)
        for d in devices:  # here, not in the shards' threads
            self.replica(d)

        def one_shard(cines, device):
            eng = self.replica(device)
            pending = [eng.segment_sequence_dispatch(c, rescale)
                       for c in cines]
            return [p.result() for p in pending]

        def run(cines):
            cines = np.asarray(cines)
            if cines.shape[1:] != cine_shape:
                raise ValueError(f"cines of shape {cines.shape[1:]}, the "
                                 f"forward was built for {cine_shape}")
            shards = split_leading(cines, mesh, axis)
            segs = map_shards(one_shard, shards, devices)
            return np.stack([s for shard in segs for s in shard])

        return run

    def segment_subjects_sharded(self, images: np.ndarray, mesh,
                                 rescale: str = "percentile",
                                 axis: str = "data") -> np.ndarray:
        """Segment a stack of S same-shape raw cines (S, X, Y, Z, T) with
        subjects split over the mesh.  Returns (S, X, Y, Z, T) uint8.  S
        need not divide the mesh axis (or reach it): the stack pads up by
        cycling subjects, and the padding is sliced off the result."""
        images, S = pad_stack_to_multiple(images, mesh.shape[axis])
        return self.make_sharded_cine_forward(mesh, images.shape[1:], rescale,
                                              axis)(images)[:S]
