"""B-spline FFD registration on the card — replaces MIRTK + average_3d_ffd.

Counterpart of ``ukbb_cardiac_tpu/reg``; the lattice → field synthesis and
its adjoint run as the CUDA kernel of ``reg/bspline_field.py``."""

from ukbb_cardiac_tpu_torch.reg.bspline import (
    bspline_dense_field,
    bspline_point_disp,
    cubic_bspline,
    fit_lattice_to_field,
    lattice_shape,
)
from ukbb_cardiac_tpu_torch.reg.losses import bending_energy, nmi, ssd
from ukbb_cardiac_tpu_torch.reg.parcfg import load_par_cfg
from ukbb_cardiac_tpu_torch.reg.register import (
    RegConfig,
    average_fields,
    compose_chain,
    compose_fields,
    gaussian_blur,
    invert_field,
    invert_field_batch,
    make_register_batch,
    make_register_pair,
    total_field,
    transform_points,
    warp_image,
)
