"""The plain reference of the ``unet_lstm_ao`` configuration's aortic
cohort stage.

For one subject's raw aortic cine it works out again, from the file and
the trained bundle alone, what the cohort's aortic stage writes: the
labels of every frame (z-score over the 10th-percentile ROI, centred pad
to 256 x 256, the U-Net over every frame, the bidirectional ConvLSTM's
scan, softmax, argmax, crop) and the area row (quality control, areas
per frame, distensibility from the subject's pulse pressure).  It runs
the frozen copy in ``benchmark/reference/port`` eagerly, in float32 with
TF32 off, and imports nothing of the program.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.fcn_sa import set_precision
from benchmark.reference.port.ckpt.convert import (convlstm_from_jax,
                                                   unet_from_jax)
from benchmark.reference.port.ckpt.store import load_model_with_extra
from benchmark.reference.port.io import nifti
from benchmark.reference.port.models.wrappers import UNetLSTM
from benchmark.reference.port.ops.crop import pad_to_size
from benchmark.reference.port.ops.intensity import normalise_intensity_torch
from benchmark.reference.stages import area_row

_NETS = {}
AREA_KEYS = [f"{v} {k}" for v in ("AAo", "DAo")
             for k in ("max area", "min area", "distensibility")]


def load_unet_lstm(bundle: str, device) -> UNetLSTM:
    key = (bundle, str(device))
    if key not in _NETS:
        kind, cfg, names, params, state, extra = load_model_with_extra(bundle)
        if kind != "unet_lstm":
            raise ValueError(f"{bundle}: a UNet-LSTM bundle was expected")
        net = UNetLSTM(unet_from_jax(params, state, names, cfg),
                       convlstm_from_jax(params,
                                         extra.get("bidirectional", True)))
        _NETS[key] = net.to(device).eval()
    return _NETS[key]


@torch.no_grad()
def segment(cine: np.ndarray, net: UNetLSTM, device, size: int
            ) -> np.ndarray:
    """Labels (X, Y, Z, T) int32 of a raw aortic cine (X, Y, Z, T)."""
    X, Y, Z, T = cine.shape
    x = normalise_intensity_torch(torch.from_numpy(
        np.ascontiguousarray(cine)).to(device), 10.0)
    x_pre, x_post, y_pre, y_post = pad_to_size(X, Y, size)
    seq = F.pad(x.permute(2, 3, 0, 1), (y_pre, y_post, x_pre, x_post))
    logits = net(seq[:, :, None])                      # (Z, T, C, X', Y')
    pred = torch.argmax(torch.softmax(logits.float(), dim=2), dim=2)
    pred = pred[:, :, x_pre:x_pre + X, y_pre:y_pre + Y]
    return pred.permute(2, 3, 0, 1).to(torch.int32).cpu().numpy()


def reference_subject(cine_path: str, config: dict, device, workdir: str,
                      pulse_pressure: float, precision: str = "float32"
                      ) -> dict:
    """{'labels', 'areas'} of one subject, worked out in ``workdir``
    (emptied first); ``areas`` is None where the labels fail the aortic
    quality control, as the cohort leaves such a subject without a row.
    ``precision`` ``tf32`` computes the control."""
    set_precision(precision)
    if os.path.exists(workdir):
        shutil.rmtree(workdir)
    os.makedirs(workdir)
    nim = nifti.load(cine_path)
    cine = np.asarray(nim.dataobj)
    if cine.ndim == 3:
        cine = cine[..., None]
    net = load_unet_lstm(config["bundle"], device)
    pred = segment(cine, net, device, config["pad_to"])
    os.symlink(os.path.abspath(cine_path), os.path.join(workdir, "ao.nii.gz"))
    out = nifti.Nifti1Image(pred.astype(np.float64), nim.affine)
    out.header["pixdim"] = nim.header["pixdim"]
    nifti.save(out, os.path.join(workdir, "seg_ao.nii.gz"))
    areas = area_row(cine, pred, nim.header, pulse_pressure)
    return {"labels": pred, "areas": areas, "stage_areas": areas}
