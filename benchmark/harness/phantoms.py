"""The benchmark's traffic generator: seeded phantom cines and NIfTI files.

The geometry is ``chip_smoke.py``'s (itself ``tests/phantom.py``'s): an SA
cine with an LV disk, a myocardial annulus and an RV crescent contracting
over the cycle (ED = frame 0), and an aortic cine with pulsating ascending
(label 1) and descending (label 2) aortic disks.  A traffic file
(``benchmark/traffic/<name>.json``) gives the shapes and the geometry; the
seed gives the noise, the order and the pulse pressures, so every seed
has the same set of sizes.  Files are written with the reference's own
NIfTI writer, so nothing here comes from the program under test.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference.port.io import nifti


def subject_rngs(seed: int, n: int, stream: int = 0):
    """``n`` independent numpy generators drawn from ``seed`` (any
    non-negative integer, however large) and a ``stream`` number."""
    seq = np.random.SeedSequence([int(seed), int(stream)])
    return [np.random.default_rng(s) for s in seq.spawn(n)]


def seeded_generator(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed),
                                                         int(stream)]))


def _disk(X, Y, cx, cy, r):
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    return ((xx - cx) ** 2 + (yy - cy) ** 2) <= r * r


def sax_phantom(X, Y, Z, T, r_lv, wall, amp=0.3, noise=0.05, rng=None):
    """SA cine: LV disk, myocardial annulus, RV crescent, cyclic
    contraction (ED = frame 0), Gaussian noise of ``noise`` x 1000 on
    every voxel.  Returns (image int16, seg int16)."""
    rng = rng or np.random.default_rng(0)
    cx, cy = X // 2, Y // 2
    scale = 1.0 - amp * np.sin(np.pi * np.arange(T) / float(T)) ** 2
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    d2 = ((xx - cx) ** 2 + (yy - cy) ** 2)[..., None]      # (X, Y, 1)
    drv = (((xx - cx)[..., None] + (r_lv * scale + wall + 4)) ** 2
           + ((yy - cy) ** 2)[..., None])                   # (X, Y, T)
    r = r_lv * scale
    lv = d2 <= r * r
    epi = d2 <= (r + wall) ** 2
    rv = (drv <= (r * 0.9 + 3) ** 2) & ~epi
    sl = np.zeros((X, Y, T), np.int16)
    sl[rv], sl[epi & ~lv], sl[lv] = 3, 2, 1
    base = np.zeros((X, Y, T), np.float32)
    base[lv], base[epi & ~lv], base[rv] = 800.0, 300.0, 700.0
    img = rng.standard_normal((X, Y, Z, T), dtype=np.float32)
    img *= noise * 1000.0
    img += base[:, :, None, :]
    np.clip(img, 0, 1000, out=img)
    seg = np.broadcast_to(sl[:, :, None, :], (X, Y, Z, T)).astype(np.int16)
    return np.round(img).astype(np.int16), seg


def ao_phantom(X, Y, T, r_aa, r_da, pulse_amp=0.15, noise=0.05, rng=None):
    """Aortic cine, one slice: pulsating ascending (label 1) and
    descending (label 2) aortic disks.  Returns (image int16, seg int16)
    of shape (X, Y, 1, T)."""
    rng = rng or np.random.default_rng(3)
    image = np.zeros((X, Y, 1, T), np.float32)
    seg = np.zeros((X, Y, 1, T), np.int16)
    pulse = 1.0 + pulse_amp * np.sin(2 * np.pi * np.arange(T) / T)
    peak = 1.0 + pulse_amp
    off_aa = max(14, int(math.ceil(r_aa * peak)) + 2)
    off_da = max(16, int(math.ceil(r_da * peak)) + 2)
    for t in range(T):
        aa = _disk(X, Y, X // 2 - off_aa, Y // 2, r_aa * pulse[t])
        da = _disk(X, Y, X // 2 + off_da, Y // 2, r_da * pulse[t])
        seg[:, :, 0, t][aa] = 1
        seg[:, :, 0, t][da & ~aa] = 2
        img = np.zeros((X, Y), np.float32)
        img[aa] = 900.0
        img[da] = 850.0
        img += rng.standard_normal((X, Y), dtype=np.float32) * (
            noise * 1000.0)
        image[:, :, 0, t] = np.clip(img, 0, 1000)
    return np.round(image).astype(np.int16), seg


def save_nifti(path, data, affine, pixdim, dt):
    """Write ``data`` with ``affine`` and the voxel size ``pixdim`` (3
    values) and, for a cine, the frame interval ``dt`` seconds."""
    hdr = nifti.Nifti1Header()
    hdr.dim[0] = data.ndim
    hdr.dim[1:1 + data.ndim] = data.shape
    hdr.pixdim[1:4] = pixdim
    if data.ndim == 4:
        hdr.pixdim[4] = dt
    nifti.save(nifti.Nifti1Image(data, np.asarray(affine, np.float64), hdr),
               path)


def make_phantom(traffic: dict, shape, rng):
    """One phantom of the traffic file's kind at ``shape`` (X, Y, Z, T):
    (image int16, truth labels int16)."""
    kind = traffic["phantom"]
    X, Y, Z, T = shape
    g = traffic["geometry"]
    if kind == "sax":
        return sax_phantom(X, Y, Z, T, g["r_lv"], g["wall"], g["amp"],
                           g["noise"], rng)
    if kind == "ao":
        if Z != 1:
            raise ValueError("an aortic phantom has one slice")
        return ao_phantom(X, Y, T, g["r_aa"], g["r_da"], g["pulse_amp"],
                          g["noise"], rng)
    raise ValueError(f"unknown phantom kind {kind!r}")
