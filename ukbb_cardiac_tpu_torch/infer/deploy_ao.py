"""Aortic cine segmentation deployment — twin of
``common/deploy_network_ao.py``, counterpart of
``ukbb_cardiac_tpu/infer/deploy_ao.py``.  The output files and printed
lines are the JAX package's.

Reference behaviour (file:line):
- z-score normalisation by default, else percentile rescale (:92-96)
- pad to a fixed 256 x 256 grid (:104-108)
- 'UNet' mode: per-frame 2D segmentation (:111-128)
- 'UNet-LSTM' / 'Temporal-UNet' mode: a sliding circular window of
  ``2*weight_R - 1`` frames, stride ``time_step``, accumulating
  triangular-weighted probabilities, then normalising (:129-183)
- ``pred = argmax(prob)``, saved as ``seg_ao.nii.gz`` (:189-196)

Window modes, as in the JAX package:
- ``window='full'`` (default, the cohort's path): the whole T-frame cine
  goes through the U-Net and the ConvLSTM scan at once, on the device from
  the cine's raw upload to the 2-bit-packed labels' readback in the NIfTI
  file's voxel order, read back as Fortran-ordered (X, Y, Z, T) labels
  (:meth:`AorticEngine.segment_cine_dispatch`, through the slice
  engine's ``dispatch_cine``).
- ``window='compat'``: the reference's sliding-window blending, windows
  on the device and blending on the host.

On the card the engine's programs are CUDA graphs captured at a shape's
first call and replayed after (``reg/programs.py``), in a cache the
engine owns, as the JAX engine's ``self._compiled``: the full-sequence
model (``_lstm_full`` / ``_temporal_unet``: the U-Net over every frame,
then the ConvLSTM's 2 x T steps, the counterpart of its ``lax.scan``, and
the softmax) keyed by the sequence's shape, and the dispatch's normalise
+ pad and argmax + crop + pack around it (the rest of ``_subject_fn``).
"""

from __future__ import annotations

import copy
import functools
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.ckpt.convert import (convlstm_from_jax,
                                                 unet_from_jax)
from ukbb_cardiac_tpu_torch.ckpt.store import load_model_with_extra
from ukbb_cardiac_tpu_torch.infer.engine import (InferenceEngine,
                                                 PendingSegmentation,
                                                 SegmentationModel,
                                                 dispatch_cine, label_bits,
                                                 pack_bits,
                                                 pad_stack_to_multiple)
from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.models.wrappers import UNetLSTM
from ukbb_cardiac_tpu_torch.ops.crop import pad_to_size
from ukbb_cardiac_tpu_torch.ops.intensity import (normalise_intensity,
                                                  normalise_intensity_torch,
                                                  rescale_intensity,
                                                  rescale_intensity_torch)
from ukbb_cardiac_tpu_torch.parallel.mesh import (canonical_device,
                                                  map_shards, split_leading)
from ukbb_cardiac_tpu_torch.reg import programs
from ukbb_cardiac_tpu_torch.utils.timing import span

AO_SIZE = 256  # fixed aortic grid (deploy_network_ao.py:105)
KINDS = ("unet_lstm", "temporal_unet", "unet")


def window_weights(weight_R: int, weight_r: float) -> np.ndarray:
    """Triangular window weights w_t = (1 - d/R)^r over a 2R-1 window
    (``deploy_network_ao.py:132-144``)."""
    time_window = weight_R * 2 - 1
    rad = (time_window - 1) // 2
    w = []
    for t in range(time_window):
        d = abs(t - rad)
        w.append(pow(1.0 - float(d) / weight_R, weight_r) if d <= weight_R else 0.0)
    return np.asarray(w, dtype=np.float32)


def _sequence_prob(kind: str, net: torch.nn.Module, dtype,
                   seq: torch.Tensor):
    """The JAX engine's ``_lstm_full`` / ``_temporal_unet``: (Z, T, X, Y)
    normalised frames -> (softmax probabilities (Z, T, n_class, X, Y)
    float32,) of the UNet-LSTM or the temporal U-Net over the whole
    sequence."""
    x = seq.to(dtype)
    if kind == "temporal_unet":
        logits = net(x[:, None])[0].transpose(1, 2)
    else:
        logits = net(x[:, :, None])
    return (torch.softmax(logits, dim=2),)


def _subject_prep(z_score: bool, pads, raw: torch.Tensor):
    """The head of the JAX engine's ``_subject_fn``: the uploaded (T, Z,
    Y, X) cine in its own dtype -> (z-scored or percentile-rescaled
    frames, centred-padded, (Z, T, X', Y') float32,)."""
    x_pre, x_post, y_pre, y_post = pads
    x = (normalise_intensity_torch(raw, 10.0) if z_score
         else rescale_intensity_torch(raw, (1.0, 99.0)))
    return (F.pad(x.permute(1, 0, 3, 2), (y_pre, y_post, x_pre, x_post)),)


def _subject_pack(shape, pads, bits: int, prob: torch.Tensor):
    """The tail of ``_subject_fn`` and the dispatch's packing: (Z, T,
    n_class, X', Y') probabilities -> the (X, Y, Z, T) cine's argmax
    labels, cropped and packed ``bits`` to a field in the NIfTI file's
    voxel order ((T, Z, Y, X) C order, x fastest), as the slice engine's
    pack: :class:`PendingSegmentation` reads both the same way."""
    X, Y = shape
    x_pre, _, y_pre, _ = pads
    pred = torch.argmax(prob, dim=2).to(torch.uint8)
    pred = pred[:, :, x_pre:x_pre + X, y_pre:y_pre + Y]
    return (pack_bits(pred.permute(1, 0, 3, 2).reshape(-1), bits),)


class AorticEngine:
    """Runs an aortic model on one device: ``kind`` ``'unet_lstm'``
    (``net`` a :class:`UNetLSTM`), ``'temporal_unet'`` (a 3D
    :class:`UNet`) or ``'unet'`` (a 2D :class:`UNet`, per frame).

    The engine owns its programs (:class:`~ukbb_cardiac_tpu_torch.reg.
    programs.ProgramCache`), over its own network's weights, bounded by
    ``reg.programs.ENGINE_BYTES`` (the least recently used dropped
    first); :meth:`release_programs` lets them go at once.
    :meth:`segment_subjects_sharded` splits whole subjects over a mesh,
    each shard through :meth:`segment_cine_dispatch` of a replica on its
    device (:meth:`replica`)."""

    def __init__(self, kind: str, net: torch.nn.Module, device=None,
                 compute_dtype=torch.float32):
        if kind not in KINDS:
            raise ValueError(f"unknown aortic model kind {kind!r}")
        self.kind = kind
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.compute_dtype = compute_dtype
        self.n_class = (net.unet if kind == "unet_lstm" else net).cfg.n_class
        self._unet_engine = None
        # this engine's programs; nothing in them refers back to the
        # engine, so they go with it
        self._programs = programs.ProgramCache(
            max_bytes=programs.ENGINE_BYTES)
        self._replicas = {}

    def replica(self, device) -> "AorticEngine":
        """The engine on ``device``: this one, or a copy of its network
        there (made at first use and kept, with programs of its own)."""
        key = str(canonical_device(device))
        if key == str(canonical_device(self.device)):
            return self
        if key not in self._replicas:
            self._replicas[key] = AorticEngine(
                self.kind, copy.deepcopy(self.net), device,
                self.compute_dtype)
        return self._replicas[key]

    def programs(self):
        """This engine's captured programs, least recently used first."""
        return self._programs.programs()

    def release_programs(self) -> None:
        """Drop this engine's programs (its replicas' and its slice
        engine's too) and return their graphs' memory to the card."""
        for eng in (*self._replicas.values(), self._unet_engine):
            if eng is not None:
                eng.release_programs()
        self._programs.clear()

    @torch.inference_mode()
    def _full_prob(self, seq: torch.Tensor) -> torch.Tensor:
        """(Z, T, X, Y) normalised frames -> softmax probabilities
        (Z, T, n_class, X, Y) float32 of the whole sequence, through this
        engine's program of the sequence's shape."""
        (prob,) = self._programs.run(
            ("full-prob",), functools.partial(
                _sequence_prob, self.kind, self.net, self.compute_dtype),
            seq)
        return prob

    @span("ukbb.engine.dispatch")
    @torch.inference_mode()
    def segment_cine_dispatch(self, image: np.ndarray, z_score: bool = True,
                              pad_to: int = AO_SIZE) -> PendingSegmentation:
        """Queue the whole deploy of a RAW cine (X, Y, Z, T) on the device —
        upload, z-score (or percentile rescale), centred pad to
        ``pad_to``, the full-sequence model, softmax, argmax, crop, 2-bit
        pack, pinned readback — and return a :class:`PendingSegmentation`
        without waiting (the JAX engine's ``_subject_fn``)."""
        if self.kind == "unet":
            raise ValueError("the full-scan path is for the LSTM/temporal "
                             "models; use prob_sequence for the UNet model")
        X, Y, Z, T = np.shape(image)
        if X > pad_to or Y > pad_to:
            raise ValueError(
                f"aortic cine {X}x{Y} exceeds the {pad_to}x{pad_to} grid "
                f"(deploy_network_ao.py:104-108 pads to a fixed size); "
                f"pass a larger pad_to")
        pads = pad_to_size(X, Y, pad_to)
        bits = label_bits(self.n_class)

        def run(raw):
            (seq,) = self._programs.run(
                ("subject-prep", z_score, pad_to),
                functools.partial(_subject_prep, z_score, pads), raw)
            (packed,) = self._programs.run(
                ("subject-pack", X, Y),
                functools.partial(_subject_pack, (X, Y), pads, bits),
                self._full_prob(seq))
            return packed

        return dispatch_cine(image, self.device, bits, run)

    def segment_cine(self, image: np.ndarray, z_score: bool = True,
                     pad_to: int = AO_SIZE) -> np.ndarray:
        """Blocking wrapper around :meth:`segment_cine_dispatch`: raw cine
        (X, Y, Z, T) -> uint8 labels."""
        return self.segment_cine_dispatch(image, z_score, pad_to).result()

    def segment_subjects_sharded(self, images, mesh, z_score: bool = True,
                                 pad_to: Optional[int] = None,
                                 axis: str = "data") -> np.ndarray:
        """Fleet aortic deploy: S same-shape raw cines (S, X, Y, Z, T) with
        whole subjects split over ``axis`` of ``mesh``; each subject's
        full bidirectional scan runs on one device, through the replica's
        :meth:`segment_cine_dispatch`.  Returns (S, X, Y, Z, T) uint8
        labels.  S need not divide the axis (or reach it): the stack pads
        up by cycling subjects, and the padding is sliced off."""
        images, S = pad_stack_to_multiple(images, mesh.shape[axis])
        pad_to = pad_to or AO_SIZE
        devices = mesh.axis_devices(axis)
        for d in devices:  # here, not in the shards' threads
            self.replica(d)

        def one_shard(cines, device):
            eng = self.replica(device)
            pending = [eng.segment_cine_dispatch(c, z_score, pad_to)
                       for c in cines]
            return [p.result() for p in pending]

        segs = map_shards(one_shard, split_leading(images, mesh, axis),
                          devices)
        return np.stack([s for shard in segs for s in shard])[:S]

    def _seq(self, image: np.ndarray) -> torch.Tensor:
        """Padded cine (X, Y, Z, T) -> (Z, T, X, Y) float32 on the device."""
        seq = np.transpose(np.asarray(image, np.float32), (2, 3, 0, 1))
        return torch.from_numpy(np.ascontiguousarray(seq)).to(self.device)

    def pred_sequence(self, image: np.ndarray, weight_R: int = 5,
                      weight_r: float = 0.0, time_step: int = 1,
                      window: str = "full") -> np.ndarray:
        """Argmax labels for a padded, normalised cine (X, Y, Z, T) ->
        (X, Y, Z, T) uint8; in full-scan mode the argmax runs on the
        device."""
        if self.kind != "unet" and window == "full":
            pred = torch.argmax(self._full_prob(self._seq(image)), dim=2)
            return pred.to(torch.uint8).permute(2, 3, 0, 1).cpu().numpy()
        prob = self.prob_sequence(image, window, weight_R, weight_r,
                                  time_step)
        return np.argmax(prob, axis=-1).astype(np.uint8)

    def unet_engine(self) -> InferenceEngine:
        """The slice engine of a ``'unet'`` model (built at first use)."""
        if self._unet_engine is None:
            self._unet_engine = InferenceEngine(SegmentationModel.from_unet(
                self.net, self.device, self.compute_dtype))
        return self._unet_engine

    def prob_sequence(self, image: np.ndarray, window: str = "full",
                      weight_R: int = 5, weight_r: float = 0.0,
                      time_step: int = 1) -> np.ndarray:
        """Probability maps for a padded, normalised cine (X, Y, Z, T) ->
        (X, Y, Z, T, n_class) float32.

        ``window='full'``: one scan over all T frames (UNet-LSTM) or one 3D
        pass (Temporal-UNet).  ``window='compat'``: the reference's sliding
        circular window with triangular blending.
        """
        X, Y, Z, T = image.shape
        if self.kind == "unet":
            _, prob = self.unet_engine().segment_sequence(
                image.astype(np.float32), want_prob=True)
            return prob

        seq = self._seq(image)
        if window == "full":
            prob = self._full_prob(seq)  # (Z, T, C, X, Y)
            return prob.permute(3, 4, 0, 1, 2).cpu().numpy()

        # compat: sliding circular windows (deploy_network_ao.py:129-183)
        time_window = weight_R * 2 - 1
        rad = (time_window - 1) // 2
        w = window_weights(weight_R, weight_r).reshape(1, 1, 1, time_window, 1)
        prob = np.zeros((X, Y, Z, T, self.n_class), dtype=np.float32)
        weight = np.zeros((1, 1, 1, T, 1), dtype=np.float32)
        for t in range(0, T, time_step):
            idx = [(i + T) % T for i in range(t - rad, t + rad + 1)]
            p = self._full_prob(seq[:, idx])  # (Z, tw, C, X, Y)
            p = p.permute(3, 4, 0, 1, 2).cpu().numpy()  # (X, Y, Z, tw, C)
            # np.add.at: when T < time_window the circular idx holds
            # DUPLICATE frames, and buffered fancy-index += keeps only the
            # last duplicate's contribution
            np.add.at(prob, (slice(None), slice(None), slice(None), idx),
                      p * w)
            np.add.at(weight, (slice(None), slice(None), slice(None), idx),
                      np.broadcast_to(w, (1, 1, 1, len(idx), 1)))
        return prob / weight


def load_aortic_engine(model_path: str, device=None,
                       compute_dtype=None) -> AorticEngine:
    """Load an aortic model bundle (.npz of kind ``unet_lstm``,
    ``temporal_unet`` or ``unet``) onto ``device`` (default ``cuda``)."""
    kind, cfg, names, params, state, extra = load_model_with_extra(model_path)
    if kind not in KINDS:
        raise ValueError(f"model kind {kind!r} is not an aortic model")
    unet = unet_from_jax(params, state, names, cfg,
                         temporal=kind == "temporal_unet")
    net = (UNetLSTM(unet, convlstm_from_jax(
        params, extra.get("bidirectional", True)))
        if kind == "unet_lstm" else unet)
    return AorticEngine(kind, net, device, compute_dtype or torch.float32)


def _read_cine(data_dir: str, seq_name: str):
    """The subject's cine and its NIfTI, or None (printing the reference's
    skip line) when the seg exists or the image is missing."""
    if os.path.exists(os.path.join(data_dir, f"seg_{seq_name}.nii.gz")):
        return None
    image_name = os.path.join(data_dir, f"{seq_name}.nii.gz")
    if not os.path.exists(image_name):
        print(f"  Directory {data_dir} does not contain an image with "
              f"file name {os.path.basename(image_name)}. Skip.")
        return None
    print(f"  Reading {image_name} ...")
    nim = nifti.load(image_name)
    image = np.asarray(nim.dataobj)
    if image.ndim == 3:  # single-frame volume, like deploy.py:79-80
        image = image[..., None]
    return nim, image


def _save_seg(nim, pred: np.ndarray, path: str) -> None:
    print("  Saving segmentation ...")
    nim2 = nifti.Nifti1Image(pred.astype(np.float64), nim.affine)
    nim2.header["pixdim"] = nim.header["pixdim"]
    nifti.save(nim2, path)


def _start_subject_ao(engine: AorticEngine, data_dir: str, seq_name: str,
                      z_score: bool) -> Optional[dict]:
    """Read one subject's aortic cine and dispatch the full-scan
    segmentation; None if skipped (the rules of ``deploy_network_ao.py``)."""
    read = _read_cine(data_dir, seq_name)
    if read is None:
        return None
    nim, image = read
    print("  Segmenting full sequence ...")
    start = time.time()
    pending = engine.segment_cine_dispatch(image, z_score=z_score)
    return {"data_dir": data_dir, "nim": nim, "pending": pending,
            "start": start}


def _finish_subject_ao(ctx: dict, seq_name: str, save_seg: bool) -> float:
    """Wait for an in-flight aortic subject and write its segmentation."""
    labels = ctx["pending"].result()
    with span("ukbb.deploy.write"):
        pred = labels.astype(np.int32)
        ctx["pred"] = pred
        seg_time = time.time() - ctx["start"]
        if save_seg:
            _save_seg(ctx["nim"], pred,
                      os.path.join(ctx["data_dir"], f"seg_{seq_name}.nii.gz"))
    print(f"  Segmentation time = {seg_time:.3f}s")
    return seg_time


def deploy_subject_ao(engine: AorticEngine, data_dir: str,
                      seq_name: str = "ao", z_score: bool = True, save_seg: bool = True,
                      window: str = "full", weight_R: int = 5,
                      weight_r: float = 0.0, time_step: int = 1
                      ) -> Optional[dict]:
    """Segment one subject's aortic cine.  Returns a record
    (``seg_time`` seconds, ``device_ms`` of the full-scan path on the card,
    else None) or None if skipped."""
    if engine.kind != "unet" and window == "full":
        ctx = _start_subject_ao(engine, data_dir, seq_name, z_score)
        if ctx is None:
            return None
        t = _finish_subject_ao(ctx, seq_name, save_seg)
        return {"seg_time": t, "device_ms": ctx["pending"].device_ms}

    read = _read_cine(data_dir, seq_name)
    if read is None:
        return None
    nim, image = read
    X, Y, Z, T = image.shape
    print("  Segmenting full sequence ...")
    start = time.time()
    image = image.astype(np.float32)
    if z_score:
        image = normalise_intensity(image, 10.0)
    else:
        image = rescale_intensity(image, (1.0, 99.0))
    x_pre, x_post, y_pre, y_post = pad_to_size(X, Y, AO_SIZE)
    padded = np.pad(image, ((x_pre, x_post), (y_pre, y_post),
                            (0, 0), (0, 0)))
    pred = engine.pred_sequence(padded, weight_R, weight_r, time_step,
                                window)
    pred = pred[x_pre:x_pre + X, y_pre:y_pre + Y].astype(np.int32)
    seg_time = time.time() - start
    if save_seg:
        _save_seg(nim, pred, os.path.join(data_dir, f"seg_{seq_name}.nii.gz"))
    print(f"  Segmentation time = {seg_time:.3f}s")
    return {"seg_time": seg_time, "device_ms": None}


def deploy_subject_ed_es_ao(engine: AorticEngine, data_dir: str,
                            seq_name: str = "ao", z_score: bool = True,
                            save_seg: bool = True) -> bool:
    """ED/ES-only aortic segmentation (UNet mode,
    ``deploy_network_ao.py:206-268``); the LSTM needs full sequences and
    the reference refuses frame-wise mode for it (:202-205)."""
    if engine.kind != "unet":
        raise ValueError("UNet-LSTM does not support frame-wise segmentation. "
                         "Please use the full-sequence mode.")
    names = {fr: os.path.join(data_dir, f"{seq_name}_{fr}.nii.gz")
             for fr in ("ED", "ES")}
    if not all(os.path.exists(p) for p in names.values()):
        print(f"  Directory {data_dir} does not contain an image with file "
              f"name {os.path.basename(names['ED'])} or "
              f"{os.path.basename(names['ES'])}. Skip.")
        return False
    for fr in ("ED", "ES"):
        nim = nifti.load(names[fr])
        image = np.asanyarray(nim.dataobj).astype(np.float32)
        if image.ndim == 2:
            image = image[..., None]
        print(f"  Segmenting {fr} frame ...")
        start = time.time()
        if z_score:
            image = normalise_intensity(image, 10.0)
        else:
            image = rescale_intensity(image, (1.0, 99.0))
        pred = engine.unet_engine().segment_volume(image).astype(np.float64)
        print(f"  Segmentation time = {time.time() - start:.3f}s")
        if save_seg:
            nim2 = nifti.Nifti1Image(pred, nim.affine)
            nim2.header["pixdim"] = nim.header["pixdim"]
            nifti.save(nim2,
                       os.path.join(data_dir, f"seg_{seq_name}_{fr}.nii.gz"))
    return True


def deploy_dataset_ao(model_path: str, data_dir: str, seq_name: str = "ao",
                      z_score: bool = True, save_seg: bool = True,
                      window: str = "full", weight_R: int = 5,
                      weight_r: float = 0.0, time_step: int = 1,
                      process_seq: bool = True, compute_dtype=None,
                      device=None) -> List[dict]:
    """Walk subject dirs and segment each aortic cine
    (``deploy_network_ao.py`` main loop) on ``device`` (default ``cuda``).

    Returns one record per segmented full sequence: ``subject``,
    ``seg_time`` (the printed seconds) and ``device_ms`` (upload to
    readback of the full-scan path on the card; None otherwise)."""
    engine = load_aortic_engine(model_path, device, compute_dtype)
    print("Start deployment on the data set ...")
    start_time = time.time()
    processed, records = [], []
    # the full-scan path pipelines one subject deep, like infer/deploy.py:
    # read + dispatch of subject N overlaps the readback + save of N-1
    pipelined = process_seq and engine.kind != "unet" and window == "full"

    def finish(data, ctx):
        t = _finish_subject_ao(ctx, seq_name, save_seg)
        processed.append(data)
        records.append({"subject": data, "seg_time": t,
                        "device_ms": ctx["pending"].device_ms})

    in_flight = None  # (data, ctx)
    for data in sorted(os.listdir(data_dir)):
        subject_dir = os.path.join(data_dir, data)
        if not os.path.isdir(subject_dir):
            continue
        print(data)
        if pipelined:
            ctx = _start_subject_ao(engine, subject_dir, seq_name, z_score)
            if in_flight is not None:
                finish(*in_flight)
            in_flight = (data, ctx) if ctx is not None else None
        elif process_seq:
            rec = deploy_subject_ao(engine, subject_dir, seq_name, z_score,
                                    save_seg, window, weight_R, weight_r,
                                    time_step)
            if rec is not None:
                processed.append(data)
                records.append({"subject": data, **rec})
        elif deploy_subject_ed_es_ao(engine, subject_dir, seq_name, z_score,
                                     save_seg):
            processed.append(data)
    if in_flight is not None:
        finish(*in_flight)
    total = time.time() - start_time
    if processed:
        print("It took {0:.3f}s for processing {1:d} subjects "
              "({2:.3f}s per subjects).".format(total, len(processed),
                                                total / len(processed)))
    # the engine goes with this call: its graphs' pools go back now
    engine.release_programs()
    return records
