"""The numbers that decide ``correct``, each a worst case over what was
compared: the program's outputs against the reference's."""

from __future__ import annotations

import math

import numpy as np


def label_mismatch(got: np.ndarray, ref: np.ndarray) -> float:
    """Share of voxels whose label differs (1.0 if the shapes differ)."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        return 1.0
    return float(np.mean(got != ref))


def relative_gap(got: dict, ref: dict) -> float:
    """Largest |got - ref| / |ref| over the reference's keys; a key
    missing on one side, or NaN on one side only, reads infinity."""
    if got is None or ref is None:
        return 0.0 if got is None and ref is None else math.inf
    worst = 0.0
    for k, r in ref.items():
        if k not in got:
            return math.inf
        g, r = float(got[k]), float(r)
        if math.isnan(g) or math.isnan(r):
            if math.isnan(g) != math.isnan(r):
                return math.inf
            continue
        worst = max(worst, abs(g - r) / max(abs(r), 1e-12))
    return worst


def table_gap(got, ref) -> float:
    """Largest absolute difference between two sets of equal-shaped
    tables ({name: array}); NaN where both are NaN is equal."""
    if got is None or ref is None:
        return 0.0 if got is None and ref is None else math.inf
    worst = 0.0
    for k, r in ref.items():
        g = got.get(k)
        if g is None or np.shape(g) != np.shape(r):
            return math.inf
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        if np.any(np.isnan(g) != np.isnan(r)):
            return math.inf
        both = ~np.isnan(r)
        if both.any():
            worst = max(worst, float(np.max(np.abs(g[both] - r[both]))))
    return worst


def strain_summary(tables):
    """The cohort's strain row: each AHA segment's and the Global
    circumferential minimum and radial maximum over the cycle (34
    values, ``parallel/cohort.py``'s ``strain_rows``)."""
    if tables is None:
        return None
    return {"circum": np.nanmin(tables["circum"], axis=1),
            "radial": np.nanmax(tables["radial"], axis=1)}


def global_rows(tables):
    """The Global rows (the last of each table) over the cycle."""
    if tables is None:
        return None
    return {k: v[-1:] for k, v in tables.items()}


def mean_table_gap(pairs) -> float:
    """Mean |got - ref| over every entry of every pair of table sets
    ({name: array}); entries NaN on both sides are left out, and a
    missing table, a shape or a NaN on one side only reads infinity."""
    total, n = 0.0, 0
    for got, ref in pairs:
        if got is None or ref is None:
            if got is None and ref is None:
                continue
            return math.inf
        for k, r in ref.items():
            g = got.get(k)
            if g is None or np.shape(g) != np.shape(r):
                return math.inf
            g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
            if np.any(np.isnan(g) != np.isnan(r)):
                return math.inf
            both = ~np.isnan(r)
            total += float(np.sum(np.abs(g[both] - r[both])))
            n += int(both.sum())
    return total / n if n else 0.0


def mean_label_mismatch(pairs) -> float:
    """Share of voxels whose label differs over every (got, ref) pair of
    label arrays; a pair whose shapes differ reads 1."""
    differ = total = 0
    for got, ref in pairs:
        got, ref = np.asarray(got), np.asarray(ref)
        if got.shape != ref.shape:
            return 1.0
        differ += int(np.count_nonzero(got != ref))
        total += ref.size
    return differ / total if total else 0.0
