"""The plain reference of the ``fcn_sa`` configuration's SA cohort chain.

For one subject's raw cine it works out again, from the file and the
trained bundle alone, what the cohort's ``process_subject_sa`` writes:
the labels of every frame (percentile rescale, centred pad to a multiple
of 16, the FCN's plain float32 forward with the published concat head,
argmax, crop), the ventricular volume row, and the SA strain tables
(crop, ED contours, the 3-level B-spline FFD registration of every
(slice, frame) pair with the two-einsum synthesis and autograd, field
composition and blending, point sampling, strain by length).  It runs
the frozen copy in ``benchmark/reference/port`` and imports nothing of
the program.  TF32 is off, as the configuration states float32.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pandas as pd
import torch
import torch.nn.functional as F

from benchmark.reference.port.ckpt.convert import fcn_from_jax
from benchmark.reference.port.ckpt.store import load_model
from benchmark.reference.port.io import nifti
from benchmark.reference.port.ops.crop import pad_to_multiple
from benchmark.reference.port.ops.intensity import rescale_intensity_torch
from benchmark.reference.port.phenotype.qc import sa_pass_quality_control
from benchmark.reference.port.phenotype.strain import (
    finish_sa_motion, start_sa_motion_dispatch)
from benchmark.reference.port.reg.register import RegConfig
from benchmark.reference.stages import volume_row

_NETS = {}


def set_precision(precision: str = "float32") -> None:
    """``float32``: TF32 off, as the configurations state; ``tf32``: the
    step below it, the control's."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def load_fcn(bundle: str, device):
    key = (bundle, str(device))
    if key not in _NETS:
        kind, cfg, names, params, state = load_model(bundle)
        if kind != "fcn":
            raise ValueError(f"{bundle}: an FCN bundle was expected")
        _NETS[key] = fcn_from_jax(params, state, names, cfg).to(
            device).eval()
    return _NETS[key]


@torch.no_grad()
def segment(cine: np.ndarray, net, device, chunk: int = 64) -> np.ndarray:
    """Labels (X, Y, Z, T) int16 of a raw cine (X, Y, Z, T)."""
    X, Y, Z, T = cine.shape
    x = torch.from_numpy(np.ascontiguousarray(cine)).to(device)
    x = rescale_intensity_torch(x, (1.0, 99.0))
    x_pre, x_post, y_pre, y_post = pad_to_multiple(X, Y, 16)
    slices = x.permute(3, 2, 0, 1).reshape(T * Z, 1, X, Y)
    slices = F.pad(slices, (y_pre, y_post, x_pre, x_post))
    preds = []
    for i in range(0, T * Z, chunk):
        logits = net(slices[i:i + chunk], fused_head=False)
        preds.append(torch.argmax(logits, dim=1))
    pred = torch.cat(preds)[:, x_pre:x_pre + X, y_pre:y_pre + Y]
    return pred.reshape(T, Z, X, Y).permute(2, 3, 1, 0).to(
        torch.int16).cpu().numpy()


def _save(path, data, nim) -> None:
    out = nifti.Nifti1Image(data, nim.affine)
    out.header["pixdim"] = nim.header["pixdim"]
    nifti.save(out, path)


def reference_subject(cine_path: str, config: dict, device, workdir: str,
                      precision: str = "float32") -> dict:
    """{'labels', 'volumes', 'strain'} of one subject, worked out in
    ``workdir`` (emptied first).  ``strain`` is None where the ED
    labels fail the SA quality control, as the cohort skips them.
    ``precision`` ``tf32`` computes the control."""
    set_precision(precision)
    if os.path.exists(workdir):
        shutil.rmtree(workdir)
    os.makedirs(workdir)
    nim = nifti.load(cine_path)
    cine = np.asarray(nim.dataobj)
    net = load_fcn(config["bundle"], device)
    pred = segment(cine, net, device, config["chunk"])
    os.symlink(os.path.abspath(cine_path), os.path.join(workdir, "sa.nii.gz"))
    _save(os.path.join(workdir, "seg_sa.nii.gz"), pred, nim)
    volumes = volume_row(pred, nim.header)
    es = int(np.argmin(np.sum(pred == 1, axis=(0, 1, 2))))
    for fr, k in (("ED", 0), ("ES", es)):
        _save(os.path.join(workdir, f"seg_sa_{fr}.nii.gz"),
              pred[:, :, :, k], nim)
    strain = None
    seg_ed = os.path.join(workdir, "seg_sa_ED.nii.gz")
    if sa_pass_quality_control(seg_ed):
        motion = os.path.join(workdir, "cine_motion")
        os.makedirs(motion)
        ctx = start_sa_motion_dispatch(workdir, motion,
                                       cfg=RegConfig(**config["registration"]),
                                       device=device)
        if ctx is not None:
            stem = os.path.join(workdir, "strain_sa")
            finish_sa_motion(ctx, stem)
            strain = read_strain(stem)
    return {"labels": pred, "volumes": volumes, "stage_volumes": volumes,
            "strain": strain}


def read_strain(stem: str):
    """The radial and circumferential tables (17 x T) a strain run wrote
    at ``stem``, or None if it wrote none."""
    out = {}
    for kind in ("radial", "circum"):
        path = f"{stem}_{kind}.csv"
        if not os.path.exists(path):
            return None
        out[kind] = pd.read_csv(path, index_col=0).values.astype(np.float64)
    return out
