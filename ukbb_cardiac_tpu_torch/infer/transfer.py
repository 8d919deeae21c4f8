"""Adaptive lossless host-to-device packing of a cine's up-leg, and link
telemetry.

Counterpart of ``ukbb_cardiac_tpu/infer/transfer.py``, which was built
for a TPU host link that could fall to tens of MB/s.  The deploy engines
ship raw int16 cines; a non-negative cine of at most 12 bits can instead
go up as one uint8 buffer:

- **Plane split.**  Values below 2^(8+h) split into a low byte and an
  h-bit high plane packed 8/h values per byte (12-bit data: h = 4, 25 %
  fewer bytes; 10-bit: h = 2, 37.5 % fewer).
- **Temporal delta.**  Frame 0 at its own width, then the zigzag deltas
  along the last (time) axis at theirs, rebuilt on the device by an
  exact int32 cumsum; chosen only when it ships ``DELTA_MIN_SAVING`` x
  fewer bytes than the plane pack.

The planner and the packer (:func:`plan_pack`, :func:`pack_buffer`) are
the JAX package's: the planner in numpy, the plane split in one native
pass (``native.pack_lo_hi_i16_into``; its numpy version, which writes
the same bytes, stays as ``pack_buffer(..., plain=True)``).
:func:`unpack_torch` is ``unpack_jax`` as tensor ops on the device:
integer shifts, ors and a cumsum, so the rebuilt cine is bit-identical
to the raw one and so are the labels.

Packing costs host time, so it pays only on a slow link: the engines pack
while :class:`BandwidthTracker` counts the link as degraded (an EMA below
``PACK_BELOW_MBPS``, or no sample yet).  On the card a sample is one
upload timed by CUDA events on the engine's stream; the events are read
when they have completed, never waited for.  :class:`TransferStats`
counts the bytes shipped and the bytes the raw path would have shipped,
and the engines' label readbacks.
"""

from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ukbb_cardiac_tpu_torch import native

# Pack below this observed host-to-device bandwidth, MB/s
PACK_BELOW_MBPS = 400.0
# Delta mode must beat plane mode by at least this byte ratio to engage
# (it costs an extra host pass computing the differences)
DELTA_MIN_SAVING = 0.92


@dataclass(frozen=True)
class PackPlan:
    """Static description of a packed transfer.

    mode 'plane': every value plane-split at width 8+hi_bits.
    mode 'delta': frame-0 section (prod(shape[:-1]) values at width
    8+f0_hi_bits) followed by zigzag temporal deltas (at 8+hi_bits); the
    device rebuilds with an exact int32 cumsum along the last axis.
    """

    shape: tuple          # original array shape (..., T)
    dtype: str            # original dtype str, e.g. '<i2'
    mode: str             # 'plane' | 'delta'
    hi_bits: int          # main-section high-plane width: 0, 2 or 4
    f0_hi_bits: int = 0   # delta mode: frame-0 section width

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def m(self) -> int:
        """Voxels per frame (delta mode's frame-0 section length)."""
        return int(np.prod(self.shape[:-1]))

    def sections(self):
        """[(length, hi_bits), ...] in buffer order."""
        if self.mode == "plane":
            return [(self.n, self.hi_bits)]
        return [(self.m, self.f0_hi_bits),
                (self.n - self.m, self.hi_bits)]


def _section_nbytes(k: int, hi_bits: int) -> int:
    return k + ((k * hi_bits + 7) // 8 if hi_bits else 0)


def packed_nbytes(plan: PackPlan) -> int:
    """Total bytes a packed transfer ships."""
    return sum(_section_nbytes(k, h) for k, h in plan.sections())


def _width_for(mx: int) -> Optional[int]:
    """hi_bits for non-negative values bounded by ``mx``; None beyond the
    12-bit packable range."""
    if mx < 256:
        return 0
    if mx < 1024:
        return 2
    if mx < 4096:
        return 4
    return None


class BandwidthTracker:
    """EMA (weight 0.5) of observed host-to-device bandwidth, MB/s; None
    until the first sample.

    On the card a sample is an upload bracketed by two CUDA events
    (:meth:`sample_upload`); :meth:`poll` folds in the samples whose end
    event has completed, without waiting for any."""

    # sample at most this often, as the JAX engines do
    SAMPLE_EVERY_S = 2.0

    def __init__(self):
        self.mbps: Optional[float] = None
        self._last_sample_t = 0.0
        self._pending = []  # (start event, end event, bytes)
        self._lock = threading.Lock()

    def want_sample(self) -> bool:
        return time.monotonic() - self._last_sample_t >= self.SAMPLE_EVERY_S

    def update(self, n_bytes: int, seconds: float) -> None:
        self._last_sample_t = time.monotonic()
        if seconds <= 0 or n_bytes <= 0:
            return
        sample = n_bytes / 1e6 / seconds
        self.mbps = sample if self.mbps is None else (
            0.5 * self.mbps + 0.5 * sample)

    def sample_upload(self, host: torch.Tensor, device) -> torch.Tensor:
        """``host.to(device)`` on the current stream, timed by CUDA events
        as a bandwidth sample (read later by :meth:`poll`)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev = host.to(device)
        end.record()
        with self._lock:
            self._last_sample_t = time.monotonic()
            self._pending.append((start, end, host.numel()
                                  * host.element_size()))
        return dev

    def poll(self) -> None:
        with self._lock:
            done = [p for p in self._pending if p[1].query()]
            self._pending = [p for p in self._pending if p not in done]
            for start, end, n_bytes in done:
                self.update(n_bytes, start.elapsed_time(end) / 1e3)

    @property
    def degraded(self) -> bool:
        """An unknown bandwidth counts as degraded: a process that
        dispatches once gets the packed up-leg."""
        self.poll()
        return self.mbps is None or self.mbps < PACK_BELOW_MBPS


@dataclass
class TransferStats:
    """Cumulative transfer accounting: on the up-leg the bytes shipped, the
    bytes the raw path would have shipped and the dispatches (packed,
    delta); on the readback the packed label bytes fetched and the
    fetches.  The JAX package's ``d2h_seconds`` (the wall time blocked in
    the fetches) is the profiler span ``ukbb.engine.wait`` here
    (``utils/timing.py``)."""

    h2d_bytes: int = 0
    h2d_raw_bytes: int = 0
    h2d_dispatches: int = 0
    packed_dispatches: int = 0
    delta_dispatches: int = 0
    d2h_bytes: int = 0
    d2h_fetches: int = 0

    def record_h2d(self, shipped: int, raw: int, plan) -> None:
        self.h2d_bytes += shipped
        self.h2d_raw_bytes += raw
        self.h2d_dispatches += 1
        if plan is not None:
            self.packed_dispatches += 1
            if plan.mode == "delta":
                self.delta_dispatches += 1

    def record_d2h(self, n_bytes: int) -> None:
        self.d2h_bytes += n_bytes
        self.d2h_fetches += 1

    def snapshot(self, bw: Optional[BandwidthTracker] = None) -> dict:
        """The counters as a dict, with the tracker's bandwidth EMA
        (``h2d_mbps_ema``, MB/s) when ``bw`` has a sample."""
        out = {
            "h2d_bytes": self.h2d_bytes,
            "h2d_raw_bytes": self.h2d_raw_bytes,
            "h2d_dispatches": self.h2d_dispatches,
            "packed_dispatches": self.packed_dispatches,
            "delta_dispatches": self.delta_dispatches,
            "d2h_bytes": self.d2h_bytes,
            "d2h_fetches": self.d2h_fetches,
        }
        if bw is not None and bw.mbps is not None:
            out["h2d_mbps_ema"] = round(bw.mbps, 1)
        return out


def plan_pack(image: np.ndarray, bw: Optional[BandwidthTracker]
              ) -> Optional[PackPlan]:
    """Decide whether and how to pack ``image`` for the up-leg.

    Returns a :class:`PackPlan`, or None for the raw path (fast link,
    non-integer dtype, negative values, or more than 12 bits).  When the
    last axis looks like time (8 frames or more) the temporal-delta
    encoding is priced too and chosen if it ships ``DELTA_MIN_SAVING`` x
    fewer bytes than the plane pack."""
    if bw is not None and not bw.degraded:
        return None
    dt = image.dtype
    if dt == np.uint8 or dt.kind not in "iu" or dt.itemsize > 2:
        return None
    mn = int(image.min())
    if mn < 0:
        return None
    mx = int(image.max())
    w = _width_for(mx)
    if w is None:
        return None
    shape = tuple(image.shape)
    plan = PackPlan(shape, dt.str, "plane", w)
    best_bytes = packed_nbytes(plan)
    T = shape[-1] if image.ndim else 1
    if image.ndim >= 2 and T >= 8 and image.size >= (1 << 16):
        # prescreen on a row subsample: its delta width only
        # underestimates the full one, so "already needs >= the plane
        # width" safely skips the full pass
        a = image.reshape(-1, T)
        if a.dtype == np.uint16:
            a = a.view(np.int16)  # exact: only values < 4096 are packed
        m = a.shape[0]
        sub = a[::max(1, m // 4096)]
        wd_sub = _delta_width(sub)
        if wd_sub is not None and wd_sub < w:
            wd = _delta_width(a)
            wf0 = _width_for(int(a[:, 0].max()))
            if wd is not None and wd < w and wf0 is not None:
                delta_bytes = (_section_nbytes(m, wf0) +
                               _section_nbytes(image.size - m, wd))
                if delta_bytes < DELTA_MIN_SAVING * best_bytes:
                    plan = PackPlan(shape, dt.str, "delta", wd, wf0)
    return plan


def _delta_width(a16: np.ndarray) -> Optional[int]:
    """Plane width of the zigzag temporal deltas of int16 rows (voxels,
    T); None beyond the packable range."""
    d = np.diff(a16, axis=-1)  # int16-exact: values < 4096
    if d.size == 0:
        return 0
    # zigzag(v) is 2v (v >= 0) or 2|v| - 1 (v < 0)
    return _width_for(max(2 * int(d.max()), -2 * int(d.min()) - 1, 0))


def _pack_section_into(vals: np.ndarray, hi_bits: int, out: np.ndarray,
                       plain: bool = False) -> None:
    """Plane-split ``vals`` (non-negative int16/uint16, flat) into the
    ``out`` uint8 slice: [lo (k)] + [hi packed] when hi_bits > 0.  The
    split runs in one native pass (``native.pack_lo_hi_i16_into``, as
    the JAX package's packer), or with ``plain`` in numpy, the plain
    version the tests and ``chip_smoke.py`` hold it to."""
    k = vals.size
    vals = np.ascontiguousarray(vals)
    if vals.dtype == np.uint16:
        vals = vals.view(np.int16)  # exact: only values < 4096 are packed
    if hi_bits == 0:
        np.copyto(out[:k], vals.astype(np.uint8))  # truncating == exact
        return
    if not plain:
        native.pack_lo_hi_i16_into(vals, hi_bits, out[:k], out[k:])
        return
    lo = vals.astype(np.uint8)
    hi = (vals >> 8).astype(np.uint8)
    per = 8 // hi_bits
    pad = (-k) % per
    if pad:
        hi = np.concatenate([hi, np.zeros(pad, np.uint8)])
    hi = hi.reshape(-1, per)
    acc = hi[:, 0].copy()
    for j in range(1, per):
        acc |= hi[:, j] << (hi_bits * j)
    np.copyto(out[:k], lo)
    np.copyto(out[k:], acc)


def pack_buffer(image: np.ndarray, plan: PackPlan,
                plain: bool = False) -> np.ndarray:
    """Pack the whole array into ONE uint8 buffer per ``plan`` (natively;
    in numpy with ``plain``: the same bytes)."""
    buf = np.empty(packed_nbytes(plan), np.uint8)
    if plan.mode == "plane":
        _pack_section_into(image.reshape(-1), plan.hi_bits, buf, plain)
        return buf
    T = plan.shape[-1]
    a = image.reshape(-1, T)
    if a.dtype == np.uint16:
        a = a.view(np.int16)  # exact: only values < 4096 are packed
    f0 = np.ascontiguousarray(a[:, 0])
    d = np.diff(a, axis=-1)  # int16-exact: |d| <= 4095
    zz = ((d << 1) ^ (d >> 15)).reshape(-1)
    o = _section_nbytes(plan.m, plan.f0_hi_bits)
    _pack_section_into(f0, plan.f0_hi_bits, buf[:o], plain)
    _pack_section_into(zz, plan.hi_bits, buf[o:], plain)
    return buf


def _unpack_section(buf: torch.Tensor, offset: int, k: int,
                    hi_bits: int) -> torch.Tensor:
    """Exact inverse of :func:`_pack_section_into` -> int32 values of
    length ``k``, on ``buf``'s device."""
    x = buf[offset:offset + k].to(torch.int32)
    if hi_bits:
        per = 8 // hi_bits
        mask = (1 << hi_bits) - 1
        hs = (k * hi_bits + 7) // 8
        hi = buf[offset + k:offset + k + hs].to(torch.int32)
        shifts = torch.arange(per, dtype=torch.int32,
                              device=buf.device) * hi_bits
        hi = ((hi[:, None] >> shifts) & mask).reshape(-1)[:k]
        x = x | (hi << 8)
    return x


_TORCH_DTYPES = {"i1": torch.int8, "i2": torch.int16, "u2": torch.int32}


def unpack_torch(buf: torch.Tensor, plan: PackPlan) -> torch.Tensor:
    """Rebuild the packed array from its uint8 buffer on ``buf``'s device
    (the JAX package's ``unpack_jax``): the original shape, in the
    original integer dtype (uint16 comes back as int32, which holds it
    exactly)."""
    if plan.mode == "plane":
        x = _unpack_section(buf, 0, plan.n, plan.hi_bits)
    else:
        m, T = plan.m, plan.shape[-1]
        o = _section_nbytes(m, plan.f0_hi_bits)
        f0 = _unpack_section(buf, 0, m, plan.f0_hi_bits)
        zz = _unpack_section(buf, o, plan.n - m, plan.hi_bits)
        d = (zz >> 1) ^ -(zz & 1)  # un-zigzag
        x = torch.cat([f0[:, None], d.reshape(m, T - 1)], dim=1)
        x = torch.cumsum(x, dim=1, dtype=torch.int32)  # exact in int32
    return x.to(_TORCH_DTYPES[np.dtype(plan.dtype).str[1:]]).reshape(
        plan.shape)


def upload_cine(image: np.ndarray, device, bw: Optional[BandwidthTracker],
                stats: Optional[TransferStats] = None,
                start=None) -> torch.Tensor:
    """The up-leg of a raw (X, Y, Z, T) cine: packed into one uint8 buffer
    while ``bw`` counts the link as degraded, else raw; one upload either
    way, sampled for bandwidth on the card when the tracker asks.
    ``start``, a CUDA event, is recorded once the host buffer is ready,
    before its upload: a device span that starts there leaves the host's
    packing out.

    Returns the engines' layout, the cine's transpose (T, Z, Y, X) as a
    contiguous tensor on ``device`` in the cine's own dtype.  The raw path
    uploads that transpose directly (for a Fortran-ordered NIfTI cine it
    is the contiguous view, so no host copy); the packed path packs the
    cine in (X, Y, Z, T) order, as the JAX engines do, so the delta mode
    runs along time, and transposes on the device."""
    plan = plan_pack(image, bw)
    if plan is None:
        # the view may be read-only (NIfTI bytes); nothing writes to it
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*not writable")
            host = torch.from_numpy(np.ascontiguousarray(image.T))
    else:
        host = torch.from_numpy(pack_buffer(np.ascontiguousarray(image),
                                            plan))
    if stats is not None:
        stats.record_h2d(host.numel() * host.element_size(), image.nbytes,
                         plan)
    device = torch.device(device)
    if start is not None:
        start.record()
    if device.type == "cuda" and bw is not None and bw.want_sample():
        dev = bw.sample_upload(host, device)
    else:
        dev = host.to(device)
    if plan is None:
        return dev
    return unpack_torch(dev, plan).permute(3, 2, 1, 0).contiguous()
