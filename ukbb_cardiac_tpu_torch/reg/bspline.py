"""Cubic B-spline free-form deformation (FFD) — the transform model.

Counterpart of ``ukbb_cardiac_tpu/reg/bspline.py``.  A control-point
lattice of spacing ``s`` pixels parameterises a smooth dense displacement
field through the cubic B-spline tensor product.  Control point ``i``
sits at pixel ``(i - 1) * s``; a lattice of ``ceil((dim-1)/s) + 3``
controls covers the image (the classic Rueckert FFD layout).

The synthesis is separable: per displacement component,
``field = Bx @ C @ Byᵀ`` with the 1D basis matrices of
:func:`basis_matrix`.  :func:`bspline_dense_field_plain` computes it with
two einsums; :func:`bspline_dense_field` is the public function, which
goes through ``reg/bspline_field.py`` (the CUDA kernel on CUDA tensors,
this plain version on CPU tensors).  Layouts are the JAX package's:
lattice (…, Cx, Cy, 2), field (…, X, Y, 2).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def cubic_bspline(t: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline basis B(t) on support |t| < 2 (elementwise)."""
    t = torch.abs(t)
    return torch.where(
        t < 1.0,
        (4.0 - 6.0 * t * t + 3.0 * (t * t * t)) / 6.0,
        torch.where(t < 2.0, ((2.0 - t) ** 3) / 6.0, torch.zeros_like(t)),
    )


def lattice_shape(image_shape: Tuple[int, int], spacing: int) -> Tuple[int, int]:
    """Number of control points per axis for an image of ``image_shape``."""
    return tuple(int(math.ceil((d - 1) / spacing)) + 3 for d in image_shape)


def _cubic_bspline_np(t: np.ndarray) -> np.ndarray:
    """float64 numpy B(t): the one source of every basis weight."""
    t = np.abs(np.asarray(t, dtype=np.float64))
    return np.where(
        t < 1.0,
        (4.0 - 6.0 * t * t + 3.0 * t ** 3) / 6.0,
        np.where(t < 2.0, ((2.0 - t) ** 3) / 6.0, 0.0),
    )


def basis_matrix(dim: int, spacing: int, n_controls: int | None = None
                 ) -> np.ndarray:
    """Dense 1D B-spline basis: B[x, i] = B((x - (i-1)s)/s), shape
    (dim, n_controls), built in float64 and cast to float32.
    ``n_controls`` defaults to the lattice that covers ``dim``; a shorter
    lattice drops columns (missing controls count as zero), a longer one
    adds columns that are zero over the image."""
    Cn = (int(math.ceil((dim - 1) / spacing)) + 3 if n_controls is None
          else n_controls)
    x = np.arange(dim)[:, None]
    i = np.arange(Cn)[None, :]
    return _cubic_bspline_np((x - (i - 1) * spacing) / spacing).astype(np.float32)


def residue_weights(spacing: int) -> np.ndarray:
    """The kernel's weight table, (spacing, 4) float32: row r holds the
    weights of controls ⌊x/s⌋ + a, a = 0..3, for every pixel x with
    x mod s = r.  Entry [r, a] is B((r - (a-1)s)/s) from the same float64
    basis, so it equals ``basis_matrix[x, ⌊x/s⌋ + a]`` bit for bit."""
    r = np.arange(spacing)[:, None]
    a = np.arange(4)[None, :]
    return _cubic_bspline_np((r - (a - 1) * spacing) / spacing).astype(
        np.float32)


_BASES = {}


def _basis(dim: int, spacing: int, n_controls: int, device) -> torch.Tensor:
    key = (dim, spacing, n_controls, str(device))
    if key not in _BASES:
        _BASES[key] = torch.from_numpy(
            basis_matrix(dim, spacing, n_controls)).to(device)
    return _BASES[key]


def bspline_dense_field_plain(control: torch.Tensor,
                              image_shape: Tuple[int, int],
                              spacing: int) -> torch.Tensor:
    """The plain version: (B, Cx, Cy, 2) lattices → (B, X, Y, 2) fields,
    ``Bx @ C @ Byᵀ`` per component in float32."""
    X, Y = image_shape
    _, Cx, Cy, _ = control.shape
    Bx = _basis(X, spacing, Cx, control.device)
    By = _basis(Y, spacing, Cy, control.device)
    return torch.einsum("xi,bijk,yj->bxyk", Bx, control, By)


def bspline_adjoint_plain(grad_field: torch.Tensor, lattice: Tuple[int, int],
                          spacing: int) -> torch.Tensor:
    """The plain adjoint: (B, X, Y, 2) field cotangents → (B, Cx, Cy, 2),
    ``Bxᵀ G By`` per component in float32."""
    _, X, Y, _ = grad_field.shape
    Cx, Cy = lattice
    Bx = _basis(X, spacing, Cx, grad_field.device)
    By = _basis(Y, spacing, Cy, grad_field.device)
    return torch.einsum("xi,bxyk,yj->bijk", Bx, grad_field, By)


def bspline_dense_field(control: torch.Tensor, image_shape: Tuple[int, int],
                        spacing: int) -> torch.Tensor:
    """Synthesise dense displacement fields from control lattices.

    control: (…, Cx, Cy, 2) displacements at control points.  Returns
    (…, X, Y, 2) dense displacements (pixel units), differentiable in
    ``control``.  The CUDA kernel runs on CUDA tensors, the plain version
    on CPU tensors (``reg/bspline_field.py``).
    """
    from ukbb_cardiac_tpu_torch.reg.bspline_field import bspline_field

    lead = control.shape[:-3]
    flat = control.reshape((-1,) + tuple(control.shape[-3:]))
    out = bspline_field(flat.contiguous(), image_shape, spacing)
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


def bspline_point_disp(control: torch.Tensor, points: torch.Tensor,
                       spacing: int) -> torch.Tensor:
    """Evaluate the FFD displacement at arbitrary (pixel) coordinates.

    control: (Cx, Cy, 2); points: (N, 2) pixel coords.  Returns (N, 2)
    displacements — the ``mirtk transform-points`` equivalent
    (``cardiac_utils.py:940,1506``).  Control indices clamp to the
    lattice, as the JAX function's do.
    """
    s = float(spacing)
    g = points / s                       # control i is at (i-1)*s
    i0 = torch.floor(g)
    u = g - i0
    i0 = i0.long()
    Cx, Cy, _ = control.shape
    acc = torch.zeros(points.shape[0], 2, dtype=control.dtype,
                      device=control.device)
    for a in range(4):
        wa = cubic_bspline(u[:, 0] - (a - 1))
        ia = torch.clamp(i0[:, 0] + a, 0, Cx - 1)
        for b in range(4):
            wb = cubic_bspline(u[:, 1] - (b - 1))
            ib = torch.clamp(i0[:, 1] + b, 0, Cy - 1)
            acc = acc + (wa * wb)[:, None] * control[ia, ib]
    return acc


def fit_lattice_to_field(field: torch.Tensor, spacing: int) -> torch.Tensor:
    """Exact least-squares fit of a control lattice to a dense (X, Y, 2)
    field (the ``mirtk compose-dofs -approximate`` refit): the synthesis
    is separable, so two pseudo-inverses solve the normal equations."""
    X, Y, _ = field.shape
    Bx = torch.from_numpy(basis_matrix(X, spacing)).to(field.device)
    By = torch.from_numpy(basis_matrix(Y, spacing)).to(field.device)
    return torch.einsum("cx,xyk,yd->cdk", torch.linalg.pinv(Bx), field,
                        torch.linalg.pinv(By).T)
