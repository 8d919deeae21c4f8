"""The least time of the FCN head on the card for one call of the deploy's
head (``csrc/fused_head.cu``'s algorithm): every product as three TF32
products (the 3xTF32 split) over the TF32 peak, beside the bilinear taps
on the CUDA cores over the float32 peak (the two units run side by side),
against the bytes (the levels' features read once, the logits written
once) over the memory rate.  The figures of ``chip_smoke.py::head_bound``,
from shapes instead of tensors."""

from __future__ import annotations

from typing import Sequence, Tuple

from benchmark.counts import peaks


def head_bound(n: int, levels: Sequence[Tuple[int, int, int]], n_class: int,
               same_dim: int, fc: int, elem_bytes: int = 4
               ) -> Tuple[float, str]:
    """``levels``: each level's (channels, X, Y) for ``n`` slices, level 0
    at full size.  Returns (seconds, 'operations' | 'bytes')."""
    pk = peaks()
    c0, X, Y = levels[0]
    pix = n * X * Y
    mma = 2 * pix * (c0 * same_dim + same_dim * fc + fc * fc + fc * n_class)
    taps = 0
    for c, x, y in levels[1:]:
        mma += 2 * n * x * y * (c * same_dim + same_dim * fc)
        taps += 2 * pix * 4 * fc
    nbytes = sum(n * c * x * y * elem_bytes for c, x, y in levels) \
        + pix * n_class * 4
    t_ops = max(3 * mma / pk["tf32_flops"], taps / pk["float32_flops"])
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fcn_head_levels(cfg: dict, X: int, Y: int):
    """The levels' (channels, X, Y) that the FCN's encoder hands the head
    for an X x Y slice."""
    out, x, y = [], X, Y
    for l in range(cfg["n_level"]):
        if l > 0:
            x, y = -(-x // 2), -(-y // 2)
        out.append((cfg["n_filter"][l], x, y))
    return out
