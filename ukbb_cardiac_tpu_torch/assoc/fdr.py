"""FDR utilities — a copy of ``ukbb_cardiac_tpu/assoc/fdr.py``, the
behavioural twin of the reference's ``assoc/my_fdr.py``.

Both functions are bit-parity contracts with short public algorithms:

- :func:`p_adjust_fdr` matches the reference's R-``p.adjust``-style
  scaling (``my_fdr.py:18-27``): adjusted(i) = p(i) * n / rank(i),
  clipped at 1, float32, WITHOUT R's monotonicity (cummin) step — that
  omission is reference behaviour, preserved deliberately (QUIRKS.md).
  For tied p-values the rank assignment follows ``np.argsort`` order,
  exactly as the reference's does.
- :func:`fdr_threshold` matches the Nichols FDR procedure
  (``my_fdr.py:30-60``; the public FDR.m from the Nichols lab): the
  largest p under the BH line, with c(V) = 1 under positive dependence
  and c(V) = H(n) (harmonic number) under arbitrary dependence.
"""

from __future__ import annotations

import numpy as np


def p_adjust_fdr(p: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg scaling ``p * n / rank``, clipped at 1 (float32)."""
    p = np.asarray(p)
    n = p.size
    ranks = np.empty(n, dtype=np.int64)
    ranks[np.argsort(p)] = np.arange(1, n + 1)
    return np.minimum((p * n / ranks).astype(np.float32),
                      np.float32(1.0))


def _largest_p_under_line(sorted_p: np.ndarray, line: np.ndarray):
    """Largest sorted p-value at or below its BH line value; 0 if none."""
    below = np.nonzero(sorted_p <= line)[0]
    return sorted_p[below[-1]] if below.size else 0


def fdr_threshold(p: np.ndarray, q: float):
    """Return ``(pID, pN)``: FDR p-value thresholds under
    independence/positive dependence and under no assumptions."""
    pv = np.asarray(p, dtype=float)
    pv = np.sort(pv[~np.isnan(pv)])
    n = pv.size
    k = np.arange(1, n + 1)
    bh_line = k * q / n
    harmonic = np.sum(1.0 / k)
    pID = _largest_p_under_line(pv, bh_line)
    pN = _largest_p_under_line(pv, bh_line / harmonic)
    return pID, pN
