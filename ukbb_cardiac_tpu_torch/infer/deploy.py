"""SA/LA segmentation deployment — file-level twin of
``common/deploy_network.py``, counterpart of
``ukbb_cardiac_tpu/infer/deploy.py``.  The output files and printed
lines are the JAX package's.

Behavioural parity points (reference file:line):
- idempotent skip when ``seg_<seq>.nii.gz`` exists (:62-67)
- intensity rescale to [0,1] at percentiles (1, 99) (:89)
- centred pad to multiple of 16 (:94-100); a TransUNet bundle pads to
  its fixed grid instead (``infer/engine.py``)
- ED = frame 0; ES = argmin(label-1 count) for sa / seg4 la_4ch,
  argmax for la views (:123-131)
- output naming incl. the ``seg4_`` prefix (:134-151) and the
  ED/ES-only mode (:152-216)
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from ukbb_cardiac_tpu_torch import resolve_device
from ukbb_cardiac_tpu_torch.ckpt.convert import (fcn_from_jax,
                                                 resnet_from_jax,
                                                 transunet_from_bundle)
from ukbb_cardiac_tpu_torch.ckpt.store import load_model
from ukbb_cardiac_tpu_torch.infer.engine import (InferenceEngine,
                                                 SegmentationModel)
from ukbb_cardiac_tpu_torch.io import nifti
from ukbb_cardiac_tpu_torch.ops.intensity import rescale_intensity
from ukbb_cardiac_tpu_torch.utils.timing import span


@span("ukbb.ckpt.load")
def load_segmentation_model(model_path: str, device=None,
                            compute_dtype=None) -> SegmentationModel:
    """Load an FCN, ResNet-FCN or TransUNet bundle (.npz) onto ``device``
    (default ``cuda``), the head or the weight standardisation folded
    there."""
    device = resolve_device(device)
    kind, cfg, names, params, state = load_model(model_path)
    dtype = compute_dtype or torch.float32
    if kind == "fcn":
        return SegmentationModel.from_fcn(
            fcn_from_jax(params, state, names, cfg), device, dtype)
    if kind == "resnet":
        return SegmentationModel.from_resnet(
            resnet_from_jax(params, state, names, cfg), device, dtype)
    if kind == "transunet":
        return SegmentationModel.from_transunet(
            transunet_from_bundle(params, state, names, cfg), device, dtype)
    raise ValueError(f"model kind {kind!r} is not an SA/LA segmenter; the "
                     "deploy takes 'fcn', 'resnet' and 'transunet' bundles")


def seg_prefix(seq_name: str, seg4: bool) -> str:
    return "seg4" if (seq_name == "la_4ch" and seg4) else "seg"


def es_frame(pred: np.ndarray, seq_name: str, seg4: bool) -> int:
    """ES frame rule (``deploy_network.py:125-131``): label-1 voxel count
    argmin for sa / seg4 (LV), argmax for la views (LA)."""
    counts = np.sum(pred == 1, axis=(0, 1, 2))
    if seq_name == "sa" or (seq_name == "la_4ch" and seg4):
        return int(np.argmin(counts))
    return int(np.argmax(counts))


def _start_subject_sequence(engine: InferenceEngine, data_dir: str,
                            seq_name: str, seg4: bool,
                            force: bool = False) -> Optional[dict]:
    """Read one subject's cine and dispatch its segmentation.

    Returns an in-flight context (finish with
    :func:`_finish_subject_sequence`) or None if skipped — the reference's
    skip rules (``deploy_network.py:62-71``); ``force`` re-segments even
    when the output exists."""
    prefix = seg_prefix(seq_name, seg4)
    seg_name = os.path.join(data_dir, f"{prefix}_{seq_name}.nii.gz")
    if os.path.exists(seg_name) and not force:
        return None
    image_name = os.path.join(data_dir, f"{seq_name}.nii.gz")
    if not os.path.exists(image_name):
        print(f"  Directory {data_dir} does not contain an image with "
              f"file name {os.path.basename(image_name)}. Skip.")
        return None

    print(f"  Reading {image_name} ...")
    nim = nifti.load(image_name)
    orig_image = np.asarray(nim.dataobj)
    if orig_image.ndim == 3:
        orig_image = orig_image[..., None]

    print("  Segmenting full sequence ...")
    start = time.time()
    pending = engine.segment_sequence_dispatch(orig_image)
    return {"data_dir": data_dir, "nim": nim, "image": orig_image,
            "pending": pending, "start": start}


def _finish_subject_sequence(ctx: dict, seq_name: str, seg4: bool,
                             save_seg: bool) -> float:
    """Wait for an in-flight subject and write its outputs.

    The printed "segmentation time" spans dispatch -> readback; in the
    pipelined dataset loop it includes reading and dispatching the NEXT
    subject while this one computed."""
    prefix = seg_prefix(seq_name, seg4)
    data_dir, nim, orig_image = ctx["data_dir"], ctx["nim"], ctx["image"]
    labels = ctx["pending"].result()
    with span("ukbb.deploy.write"):
        pred = labels.astype(np.int16)
        ctx["pred"] = pred
        seg_time = time.time() - ctx["start"]
        print(f"  Segmentation time = {seg_time:.3f}s")

        k = {"ED": 0, "ES": es_frame(pred, seq_name, seg4)}
        print("  ED frame = {0:d}, ES frame = {1:d}".format(k["ED"],
                                                          k["ES"]))

        if save_seg:
            print("  Saving segmentation ...")
            nim2 = nifti.Nifti1Image(pred, nim.affine)
            nim2.header["pixdim"] = nim.header["pixdim"]
            nifti.save(nim2, os.path.join(data_dir,
                                          f"{prefix}_{seq_name}.nii.gz"))
            for fr in ("ED", "ES"):
                nifti.save(nifti.Nifti1Image(orig_image[:, :, :, k[fr]],
                                             nim.affine),
                           os.path.join(data_dir, f"{seq_name}_{fr}.nii.gz"))
                nifti.save(nifti.Nifti1Image(pred[:, :, :, k[fr]],
                                             nim.affine),
                           os.path.join(data_dir,
                                        f"{prefix}_{seq_name}_{fr}.nii.gz"))
    return seg_time


def deploy_subject_sequence(engine: InferenceEngine, data_dir: str,
                            seq_name: str, seg4: bool = False,
                            save_seg: bool = True) -> Optional[float]:
    """Segment one subject's full cine and write its outputs.  Returns the
    segmentation seconds, or None if skipped."""
    ctx = _start_subject_sequence(engine, data_dir, seq_name, seg4)
    if ctx is None:
        return None
    return _finish_subject_sequence(ctx, seq_name, seg4, save_seg)


def deploy_subject_ed_es(engine: InferenceEngine, data_dir: str,
                         seq_name: str, seg4: bool = False,
                         save_seg: bool = True) -> List[float]:
    """ED/ES-only mode (``deploy_network.py:152-216``).  Returns the
    per-frame segmentation times."""
    prefix = seg_prefix(seq_name, seg4)
    names = {fr: os.path.join(data_dir, f"{seq_name}_{fr}.nii.gz")
             for fr in ("ED", "ES")}
    if not all(os.path.exists(p) for p in names.values()):
        print(f"  Directory {data_dir} does not contain an image with file "
              f"name {os.path.basename(names['ED'])} or "
              f"{os.path.basename(names['ES'])}. Skip.")
        return []
    times = []
    for fr in ("ED", "ES"):
        nim = nifti.load(names[fr])
        image = np.asarray(nim.dataobj)
        if image.ndim == 2:
            image = image[..., None]
        print(f"  Segmenting {fr} frame ...")
        start = time.time()
        image = rescale_intensity(image.astype(np.float32), (1.0, 99.0))
        pred = engine.segment_volume(image).astype(np.int16)
        times.append(time.time() - start)
        print(f"  Segmentation time = {times[-1]:.3f}s")
        if save_seg:
            nim2 = nifti.Nifti1Image(pred, nim.affine)
            nim2.header["pixdim"] = nim.header["pixdim"]
            nifti.save(nim2, os.path.join(
                data_dir, f"{prefix}_{seq_name}_{fr}.nii.gz"))
    return times


def deploy_dataset(model_path: str, data_dir: str, seq_name: str = "sa",
                   process_seq: bool = True, save_seg: bool = True,
                   seg4: bool = False, chunk: int = 64, compute_dtype=None,
                   device=None) -> List[dict]:
    """Walk subject subdirectories and segment each — the reference CLI's
    main loop (``deploy_network.py:43-225``), on ``device`` (default
    ``cuda``).

    Returns one record per segmented full sequence: ``subject``,
    ``seg_time`` (the printed seconds) and ``device_ms`` (upload to
    readback on the card's stream; None on the CPU).  ED/ES-only mode
    returns no records."""
    model = load_segmentation_model(model_path, device, compute_dtype)
    engine = InferenceEngine(model, chunk=chunk)

    print("Start deployment on the data set ...")
    start_time = time.time()
    table_time, processed, records = [], [], []

    def finish(data, ctx):
        t = _finish_subject_sequence(ctx, seq_name, seg4, save_seg)
        table_time.append(t)
        processed.append(data)
        records.append({"subject": data, "seg_time": t,
                        "device_ms": ctx["pending"].device_ms})

    # full-sequence mode runs a one-deep pipeline: subject N's NIfTI read
    # and dispatch overlap subject N-1's compute and readback
    in_flight = None  # (data, ctx)
    for data in sorted(os.listdir(data_dir)):
        subject_dir = os.path.join(data_dir, data)
        if not os.path.isdir(subject_dir):
            continue
        print(data)
        if process_seq:
            ctx = _start_subject_sequence(engine, subject_dir, seq_name, seg4)
            if in_flight is not None:
                finish(*in_flight)
            in_flight = (data, ctx) if ctx is not None else None
        else:
            ts = deploy_subject_ed_es(engine, subject_dir, seq_name, seg4,
                                      save_seg)
            if ts:
                table_time.extend(ts)
                processed.append(data)
    if in_flight is not None:
        finish(*in_flight)

    if table_time:
        unit = "sequence" if process_seq else "frame"
        print("Average segmentation time = {0:.3f}s per {1}".format(
            np.mean(table_time), unit))
        total = time.time() - start_time
        print("Including image I/O, it took {0:.3f}s for processing {1:d} "
              "subjects ({2:.3f}s per subjects).".format(
                  total, len(processed), total / max(len(processed), 1)))
    # the engine goes with this call: its graphs' pools go back now
    engine.release_programs()
    return records
