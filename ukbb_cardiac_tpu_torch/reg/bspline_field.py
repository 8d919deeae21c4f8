"""Batched B-spline lattice → dense field synthesis and its adjoint.

Replaces the Pallas TPU kernel ``ukbb_cardiac_tpu/reg/pallas_bspline.py:84``
(``pallas_dense_field``), which takes one lattice and has no gradient; the
JAX registration differentiates through the same function in its conv
form (``reg/bspline.py::bspline_dense_field`` under ``jax.grad``).  Here
one ``torch.autograd.Function`` covers both directions for a batch:

- forward  (B, Cx, Cy, 2) → (B, X, Y, 2): ``csrc/bspline_field.cu``
  ``field_kernel`` (one block per pair and band of pixel rows that
  :func:`field_plan` lays out; 16-byte stores) on CUDA tensors,
  :func:`bspline_dense_field_plain` on CPU tensors;
- backward (B, X, Y, 2) → (B, Cx, Cy, 2), ``Bxᵀ G By``
  (:func:`bspline_field_adjoint`): the kernel's ``adjoint_kernel``
  (one block per pair over the bands :func:`adjoint_plan` lays out;
  deterministic, no atomics) on CUDA tensors,
  :func:`bspline_adjoint_plain` on CPU tensors.

Nothing falls back from CUDA to the plain version.  Both kernels are bound
by bytes (the field written or read once); see the source for the count.
``bspline_field.launches`` and ``bspline_field.adjoint_launches`` count
kernel launches (inside a CUDA graph, at each replay:
``kernels.count_launches``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from ukbb_cardiac_tpu_torch import kernels
from ukbb_cardiac_tpu_torch.reg.bspline import (bspline_adjoint_plain,
                                                bspline_dense_field_plain,
                                                residue_weights)

_TABLES = {}


def weight_table(spacing: int, device) -> torch.Tensor:
    """The (spacing, 4) float32 residue weight table on ``device``."""
    key = (spacing, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(residue_weights(spacing)).to(device)
    return _TABLES[key]


# The forward's blocks: whole runs of s rows of a pair, about
# FIELD_BLOCK_ROWS rows (the best of 1, 2 and 4 runs at every strain and
# propagation shape on the H100, PERF.md section 6), one thread per pair
# of columns and run, up to FIELD_MAX_THREADS, each storing its values
# from registers.
FIELD_BLOCK_ROWS = 20
FIELD_MAX_THREADS = 256


@lru_cache(maxsize=None)
def field_plan(image_shape: Tuple[int, int],
               spacing: int) -> Tuple[int, int]:
    """How ``field_kernel`` cuts a pair: (rows, threads), blocks of as
    many whole runs of s rows as make about FIELD_BLOCK_ROWS rows (at
    least one run, at most the image), a thread per pair of columns and
    run of the block, in whole warps."""
    X, Y = image_shape
    rows = min(max(1, FIELD_BLOCK_ROWS // spacing) * spacing, X)
    items = (Y + 1) // 2 * -(-rows // spacing)
    return rows, min(FIELD_MAX_THREADS, -(-items // 32) * 32)


# The adjoint's shared memory for its partial sums and two staged chunks:
# up to two blocks per SM.  A band that cannot fit one row of each takes up
# to the most a block may have (227 KB), less the weight table.  Pass 1
# gives each of the block's threads one column of a slice.
ADJOINT_SMEM_BUDGET = 96 * 1024
ADJOINT_SMEM_MAX = 227 * 1024
ADJOINT_THREADS = 256
ADJOINT_CHUNK_ROWS = 40


def _band_extent(n_ctl: int, band: int, dim: int, spacing: int) -> int:
    """Pixels of the widest support of ``band`` consecutive controls."""
    return max(min(dim, (c0 + band) * spacing) - max(0, (c0 - 3) * spacing)
               for c0 in range(0, n_ctl, band))


@lru_cache(maxsize=None)
def adjoint_plan(lattice: Tuple[int, int], image_shape: Tuple[int, int],
                 spacing: int) -> Tuple[int, int, int, int]:
    """How ``adjoint_kernel`` walks one pair: (ni, nj, rows, width) —
    control rows and columns per band, cotangent rows per staged chunk,
    and the widest band's columns.  The whole lattice is one band when its
    partial sums fit half of ADJOINT_SMEM_BUDGET; the rows then come in
    chunks, so every cotangent byte is read once.  Bands share the 3s rows
    or columns between them, which are read once per band."""
    (Cx, Cy), (X, Y), s = lattice, image_shape, spacing
    budget = ADJOINT_SMEM_BUDGET

    def need(width, ni, rows):  # bytes of partial sums and two chunks
        return 8 * (ni * width + 2 * rows * min(width, ADJOINT_THREADS))

    nj = Cy
    while nj > 1 and need(_band_extent(Cy, nj, Y, s), 1, 1) > budget:
        nj = (nj + 1) // 2
    width = max(_band_extent(Cy, nj, Y, s), 1)
    if need(width, 1, 1) > budget:
        budget = ADJOINT_SMEM_MAX - 16 * s - 16
        if need(width, 1, 1) > budget:
            raise ValueError(f"spacing {spacing}: one band of the adjoint "
                             f"does not fit in shared memory")
    ni = min(Cx, max(1, budget // 2 // (8 * width)))
    rows = (budget - 8 * ni * width) // (16 * min(width, ADJOINT_THREADS))
    extent = max(_band_extent(Cx, ni, X, s), 1)
    rows = max(1, min(rows, max(ADJOINT_CHUNK_ROWS, s)))
    if s < rows < extent:  # whole runs of s rows per chunk
        rows -= rows % s
    return ni, nj, min(rows, extent), width


def _launch(symbol: str, src: torch.Tensor, out: torch.Tensor,
            lattice: Tuple[int, int], image_shape: Tuple[int, int],
            spacing: int, *plan: int) -> None:
    lib = kernels.load("bspline_field")
    B = src.shape[0]
    (Cx, Cy), (X, Y) = lattice, image_shape
    if B * X * Y >= 2 ** 31 or B > 65535:
        raise ValueError(f"{B} fields of {X}x{Y}: too many for the kernel's "
                         f"grid (B <= 65535, B*X*Y < 2^31)")
    dev = src.device
    table = weight_table(spacing, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, symbol)(B, Cx, Cy, X, Y, spacing, *plan,
                                  table.data_ptr(), src.data_ptr(),
                                  out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {rc} "
                           f"({kernels.error_string(lib, rc)})")


class _BSplineField(torch.autograd.Function):

    @staticmethod
    def forward(ctx, control, X, Y, spacing):
        ctx.meta = (tuple(control.shape[1:3]), spacing)
        if control.device.type == "cpu":
            return bspline_dense_field_plain(control, (X, Y), spacing)
        out = torch.empty((control.shape[0], X, Y, 2), dtype=torch.float32,
                          device=control.device)
        if control.shape[0]:
            _launch("ukbb_bspline_field", control, out, ctx.meta[0], (X, Y),
                    spacing, *field_plan((X, Y), spacing))
            kernels.count_launches(bspline_field, 1)
        return out

    @staticmethod
    def backward(ctx, grad):
        lattice, spacing = ctx.meta
        return bspline_field_adjoint(grad.contiguous(), lattice,
                                     spacing), None, None, None


def bspline_field_adjoint(grad: torch.Tensor, lattice: Tuple[int, int],
                          spacing: int) -> torch.Tensor:
    """(B, X, Y, 2) field cotangents → (B, Cx, Cy, 2) lattice gradients,
    ``Bxᵀ G By``: the adjoint kernel on a CUDA tensor, the plain adjoint on
    a CPU tensor.  ``grad`` is contiguous float32 (the backward pass makes
    it so)."""
    if grad.device.type == "cpu":
        return bspline_adjoint_plain(grad, lattice, spacing)
    B, X, Y, _ = grad.shape
    out = torch.empty((B,) + tuple(lattice) + (2,), dtype=torch.float32,
                      device=grad.device)
    if B:
        _launch("ukbb_bspline_field_adjoint", grad, out, lattice, (X, Y),
                spacing, *adjoint_plan(tuple(lattice), (X, Y), spacing))
        kernels.count_launches(bspline_field, 1, "adjoint_launches")
    return out


def bspline_field(control: torch.Tensor, image_shape: Tuple[int, int],
                  spacing: int) -> torch.Tensor:
    """(B, Cx, Cy, 2) float32 lattices → (B, X, Y, 2) dense fields,
    differentiable in ``control``.  Controls beyond the lattice count as
    zero.  Raises on a device other than cuda or cpu and on an input that
    is not contiguous float32."""
    if control.device.type not in ("cuda", "cpu"):
        raise ValueError(f"bspline_field runs on cuda or cpu, not "
                         f"{control.device}")
    if control.dtype != torch.float32:
        raise TypeError(f"lattices must be float32, got {control.dtype}")
    if control.dim() != 4 or control.shape[-1] != 2:
        raise ValueError(f"lattices must be (B, Cx, Cy, 2), got "
                         f"{tuple(control.shape)}")
    if not control.is_contiguous():
        raise ValueError("lattices must be contiguous")
    X, Y = (int(d) for d in image_shape)
    if int(spacing) < 1:
        raise ValueError(f"spacing must be >= 1, got {spacing}")
    return _BSplineField.apply(control, X, Y, int(spacing))


bspline_field.launches = 0
bspline_field.adjoint_launches = 0
