"""Per-tensor fingerprints of a model bundle: an offline conversion audit.

A copy of ``ukbb_cardiac_tpu/ckpt/fingerprint.py``.  For every array of
a ``.npz`` bundle (one that ``ckpt/tf_reader.py`` converted, or any
other) it records

    name, shape, dtype, sha256(raw bytes)[:16], mean/std/min/max

so that two conversions of one checkpoint can be diffed without running
either forward: a transposition, flip or dtype drift shows up as a
changed hash on exactly the affected tensors.  The JSON it writes for a
bundle equals the JAX package's byte for byte;
``cli.verify_checkpoint --fingerprint out.json`` writes one and
``--fingerprint_diff a.json b.json`` compares two.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict

import numpy as np


def _tensor_entry(arr: np.ndarray) -> Dict:
    arr = np.asarray(arr)
    raw = np.ascontiguousarray(arr).tobytes()
    ent = {
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
        "sha256_16": hashlib.sha256(raw).hexdigest()[:16],
    }
    if arr.size and np.issubdtype(arr.dtype, np.number):
        a64 = arr.astype(np.float64)
        ent.update(mean=float(a64.mean()), std=float(a64.std()),
                   min=float(a64.min()), max=float(a64.max()))
    return ent


def fingerprint_bundle(bundle_path: str) -> Dict:
    """Fingerprint every array of a converted ``.npz`` bundle.

    Returns {"bundle": ..., "n_tensors": N, "tensors": {name: entry}}
    with tensors sorted by name (stable diffs).
    """
    out: Dict = {"bundle": bundle_path, "tensors": {}}
    with np.load(bundle_path, allow_pickle=False) as z:
        for name in sorted(z.files):
            out["tensors"][name] = _tensor_entry(z[name])
    out["n_tensors"] = len(out["tensors"])
    return out


def write_fingerprint(bundle_path: str, json_path: str) -> Dict:
    fp = fingerprint_bundle(bundle_path)
    with open(json_path, "w") as f:
        json.dump(fp, f, indent=1, sort_keys=True)
    return fp


def diff_fingerprints(a: Dict, b: Dict) -> Dict:
    """Compare two fingerprint dicts: returns {missing, extra, changed}
    tensor-name lists (changed = same name, different hash/shape/dtype)."""
    ta, tb = a["tensors"], b["tensors"]
    missing = sorted(set(ta) - set(tb))
    extra = sorted(set(tb) - set(ta))
    changed = sorted(
        n for n in set(ta) & set(tb)
        if (ta[n]["sha256_16"] != tb[n]["sha256_16"]
            or ta[n]["shape"] != tb[n]["shape"]
            or ta[n]["dtype"] != tb[n]["dtype"]))
    return {"missing": missing, "extra": extra, "changed": changed}
