"""The least time of the B-spline lattice -> field synthesis and of its
adjoint (``csrc/bspline_field.cu``) for one call: the bytes (each input
read once, each output written once) over the memory rate, against the
float32 FMAs of the separable algorithm over the float32 peak.  The
figures of ``chip_smoke.py::bspline_bounds``."""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.counts import peaks


def bspline_bounds(B: int, lattice: Tuple[int, int],
                   image: Tuple[int, int], s: int
                   ) -> Dict[str, Tuple[float, str]]:
    """{'synthesis' | 'adjoint': (seconds, 'bytes' | 'operations')} for
    ``B`` lattices of (Cx, Cy) controls at spacing ``s`` over X x Y."""
    pk = peaks()
    (Cx, Cy), (X, Y) = lattice, image
    lat, field = B * Cx * Cy * 2 * 4, B * X * Y * 2 * 4
    table = 4 * s * 4
    fwd_flop = 2 * B * 2 * (Y * -(-X // s) * 16 + X * Y * 4)

    def support(n_ctl, n):  # each control's pixels along one axis
        return sum(max(min(n, (i + 1) * s) - max(0, (i - 3) * s), 0)
                   for i in range(n_ctl))

    adj_flop = 2 * B * 2 * (support(Cx, X) * Y + Cx * support(Cy, Y))
    out = {}
    for name, nbytes, flop in (("synthesis", lat + field + table, fwd_flop),
                               ("adjoint", field + lat + table, adj_flop)):
        t_b = nbytes / pk["hbm_bytes_per_s"]
        t_o = flop / pk["float32_flops"]
        out[name] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    return out


def lattice_shape(image: Tuple[int, int], spacing: int) -> Tuple[int, int]:
    """Controls per axis that cover ``image`` at ``spacing`` (the FFD
    layout: control i at pixel (i - 1) * spacing)."""
    return tuple(-(-(d - 1) // spacing) + 3 for d in image)


def registration_calls(B: int, image: Tuple[int, int], reg: dict):
    """Every synthesis and adjoint call of one multi-level registration of
    ``B`` pairs on a padded ``image`` and the dense fields after it:
    [(kind, B, lattice, image, spacing)].  Per level: each Adam step's
    synthesis and adjoint; the finished levels densified at its
    resolution; then every level densified at full size."""
    L, s0, iters = reg["levels"], reg["spacing"], reg["iters"]
    factors = [2 ** (L - 1 - l) for l in range(L)]
    f0 = factors[0]
    Xp, Yp = (-(-image[0] // f0) * f0, -(-image[1] // f0) * f0)
    shapes = [(Xp // f, Yp // f) for f in factors]
    lats = [lattice_shape(sh, s0) for sh in shapes]
    calls = []
    for l in range(L):
        for m in range(l):
            calls.append(("synthesis", B, lats[m], shapes[l],
                          s0 * factors[m] // factors[l]))
        calls += [("synthesis", B, lats[l], shapes[l], s0),
                  ("adjoint", B, lats[l], shapes[l], s0)] * iters
    for l in range(L):
        calls.append(("synthesis", B, lats[l], (Xp, Yp), s0 * factors[l]))
    return calls
