"""Batched segmentation inference engine.

Counterpart of ``ukbb_cardiac_tpu/infer/engine.py``.  A whole cine's Z*T
slices go through the network in chunks on the device, and only
2-bit-packed labels come back to the host:

  raw cine -> percentile rescale (device) -> centred pad to a multiple of
  16 -> (T, Z) frame-major slices -> chunked FCN forward with the fused
  CUDA head -> uint8 argmax -> crop -> bit pack (low field first) ->
  non-blocking copy into pinned host memory.

:meth:`InferenceEngine.segment_sequence_dispatch` returns as soon as that
work is queued; :meth:`PendingSegmentation.result` waits for it and
unpacks.  The cine goes up raw, or packed into one uint8 buffer while
the engine's bandwidth tracker counts the link as degraded (no sample
yet, or slow), and is rebuilt exactly on the device
(``infer/transfer.py``), so the labels are the same either way.

:meth:`InferenceEngine.segment_sequence_fused` is the same pipeline
waited for, with the rescale chosen ('percentile', 'zscore' or 'none').
The ResNet-FCN deploys as the FCN does: it shares the head, so the same
folded weights and head kernel serve it.

The same engine runs a 2D U-Net (``SegmentationModel.from_unet``, the
aortic deploy's ``'unet'`` kind) over normalised slices, with the softmax
probabilities on request (``want_prob``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ukbb_cardiac_tpu_torch import native
from ukbb_cardiac_tpu_torch.infer import transfer
from ukbb_cardiac_tpu_torch.models.fcn import FCN, nchw
from ukbb_cardiac_tpu_torch.models.fused_head import (HeadWeights,
                                                      apply_fcn_fused,
                                                      fold_head)
from ukbb_cardiac_tpu_torch.models.unet import UNet
from ukbb_cardiac_tpu_torch.ops.crop import pad_to_multiple
from ukbb_cardiac_tpu_torch.ops.intensity import (normalise_intensity_torch,
                                                  rescale_intensity_torch)


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
    ResNet-FCN) and its folded head weights, or a 2D U-Net (``head``
    None).
    :meth:`forward` maps (N, X, Y, C) images to channels-first float32
    logits (N, n_class, X, Y)."""

    net: FCN | UNet
    head: HeadWeights | None
    compute_dtype: torch.dtype
    n_class: int

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

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.head is None:
            return self.net(nchw(images, self.compute_dtype))[0]
        return apply_fcn_fused(self.net, images, self.head,
                               self.compute_dtype)


class PendingSegmentation:
    """Handle for a cine segmentation still in flight.

    On the card the packed labels are being copied into pinned host
    memory behind an event; ``result()`` waits on that event and unpacks
    to (X, Y, Z, T) uint8 labels.  ``device_ms`` is then the time on the
    stream from the cine's upload to the end of the readback (CUDA
    events), or None on the CPU.
    """

    def __init__(self, packed_host: torch.Tensor, out_shape, bits: int,
                 events=None):
        self._packed = packed_host
        self._shape = tuple(out_shape)
        self._bits = bits
        self._events = events
        self.device_ms = None

    def result(self) -> np.ndarray:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
        n = int(np.prod(self._shape))
        # one native pass through a per-byte table (the JAX engine's);
        # the numpy unpack builds a (bytes, 8 / bits) temporary
        return native.unpack_bits(self._packed.numpy(), self._bits,
                                  n).reshape(self._shape)


_HOST_DTYPES = (np.float32, np.int16, np.uint8, np.int8, np.int32)


class InferenceEngine:
    """Chunked slice segmentation on the model's device.

    ``chunk``: slices per forward (64 keeps the encoder's activations of
    a 192x208 chunk near 1 GB in float32).  ``pad_factor``: spatial
    padding multiple (16 = the FCN's 2^(n_level-1)).
    """

    def __init__(self, model: SegmentationModel, chunk: int = 64,
                 pad_factor: int = 16):
        self.model = model
        self.chunk = chunk
        self.pad_factor = pad_factor
        self.device = model.device
        # the adaptive packed up-leg (infer/transfer.py)
        self._bw = transfer.BandwidthTracker()
        self._stats = transfer.TransferStats()

    def _pack_bits(self) -> int:
        n = self.model.n_class
        return 2 if n <= 4 else (4 if n <= 16 else 8)

    def _labels(self, x: torch.Tensor, chunk: int,
                probs: torch.Tensor | None = None) -> torch.Tensor:
        """(N, X, Y, C) padded float32 slices -> (N, X, Y) uint8 argmax,
        ``chunk`` slices per forward; with ``probs`` (N, X, Y, n_class)
        given, the softmax probabilities are written there too."""
        preds = torch.empty(x.shape[:3], dtype=torch.uint8, device=x.device)
        for i in range(0, x.shape[0], chunk):
            logits = self.model.forward(x[i:i + chunk])
            preds[i:i + chunk] = torch.argmax(logits, dim=1)
            if probs is not None:
                probs[i:i + chunk] = torch.softmax(logits, dim=1).permute(
                    0, 2, 3, 1)
        return preds

    @torch.inference_mode()
    def run_slices(self, slices: np.ndarray, want_prob: bool = False):
        """Segment a stack of intensity-normalised 2D slices (N, X, Y) or
        (N, X, Y, C).  Padding and cropping are handled here.  Returns
        pred (N, X, Y) uint8, and with ``want_prob`` also the softmax
        probabilities (N, X, Y, n_class) float32."""
        slices = np.asarray(slices, dtype=np.float32)
        if slices.ndim == 3:
            slices = slices[..., None]
        X, Y = slices.shape[1:3]
        x_pre, x_post, y_pre, y_post = pad_to_multiple(X, Y, self.pad_factor)
        x = torch.from_numpy(np.ascontiguousarray(slices)).to(self.device)
        x = F.pad(x, (0, 0, y_pre, y_post, x_pre, x_post))
        probs = (x.new_empty(x.shape[:3] + (self.model.n_class,))
                 if want_prob else None)
        pred = self._labels(x, self.chunk, probs)
        window = (slice(None), slice(x_pre, x_pre + X),
                  slice(y_pre, y_pre + Y))
        pred = pred[window].cpu().numpy()
        if want_prob:
            return pred, probs[window].cpu().numpy()
        return pred

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
        image = np.asarray(image)
        if image.dtype not in _HOST_DTYPES:
            # uint16 and wider types go up as float32 (exact for 16-bit
            # values), as the JAX engine ships them
            image = image.astype(np.float32)
        X, Y, Z, T = image.shape
        N = T * Z
        x_pre, x_post, y_pre, y_post = pad_to_multiple(X, Y, self.pad_factor)
        # a short cine is not padded up to a whole chunk
        chunk = min(self.chunk, -(-N // 8) * 8)
        bits = self._pack_bits()
        on_card = self.device.type == "cuda"
        events = None
        if on_card:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))

        # (T, Z, Y, X): the contiguous view of a Fortran-ordered NIfTI
        # cine, raw or rebuilt from the packed buffer; the device span
        # starts at its upload
        cine = transfer.upload_cine(image, self.device, self._bw,
                                    self._stats,
                                    start=events[0] if on_card else None)
        if rescale == "percentile":
            cine = rescale_intensity_torch(cine, (1.0, 99.0))
        elif rescale == "zscore":
            cine = normalise_intensity_torch(cine)
        else:
            cine = cine.float()
        slices = cine.transpose(2, 3).reshape(N, X, Y)
        slices = F.pad(slices, (y_pre, y_post, x_pre, x_post))
        preds = self._labels(slices[..., None], chunk)
        seg = preds[:, x_pre:x_pre + X, y_pre:y_pre + Y]
        seg = seg.reshape(T, Z, X, Y).permute(2, 3, 1, 0).reshape(-1)
        packed = pack_bits(seg, bits)

        if on_card:
            host = torch.empty(packed.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            events[1].record()
        else:
            host = packed
        return PendingSegmentation(host, (X, Y, Z, T), bits, events)
