"""Similarity metrics and regularisers for FFD registration, batched over
a leading axis.

Counterpart of ``ukbb_cardiac_tpu/reg/losses.py`` (SSD + bending energy of
``par/ffd_cine_2d_motion.cfg``, NMI of ``par/ffd_aortic_motion.cfg``).
Where the JAX functions take one image or field and are ``vmap``-ed, these
take (…, X, Y) images and (…, X, Y, 2) fields and return one value per
leading index.
"""

from __future__ import annotations

import torch

_XY = (-2, -1)


def ssd(a: torch.Tensor, b: torch.Tensor, mask=None) -> torch.Tensor:
    """Sum-of-squared-differences, mean over each (X, Y) image."""
    d = (a - b) ** 2
    if mask is not None:
        return (torch.sum(d * mask, dim=_XY)
                / torch.clamp(torch.sum(mask, dim=_XY), min=1.0))
    return torch.mean(d, dim=_XY)


def bending_energy(field: torch.Tensor) -> torch.Tensor:
    """Thin-plate bending energy of (…, X, Y, 2) displacement fields: mean
    of squared second derivatives  u_xx² + 2 u_xy² + u_yy²."""
    u = field
    dxx = u[..., 2:, :, :] - 2 * u[..., 1:-1, :, :] + u[..., :-2, :, :]
    dyy = u[..., :, 2:, :] - 2 * u[..., :, 1:-1, :] + u[..., :, :-2, :]
    dxy = (u[..., 2:, 2:, :] - u[..., 2:, :-2, :] - u[..., :-2, 2:, :]
           + u[..., :-2, :-2, :]) / 4.0
    dims = (-3, -2, -1)
    return (torch.mean(dxx ** 2, dim=dims) + 2 * torch.mean(dxy ** 2, dim=dims)
            + torch.mean(dyy ** 2, dim=dims))


def nmi(a: torch.Tensor, b: torch.Tensor, n_bins: int = 32) -> torch.Tensor:
    """Normalised mutual information  (H(A) + H(B)) / H(A,B)  of each
    (X, Y) pair, with a linear-Parzen joint histogram — differentiable;
    higher is better (``par/ffd_aortic_motion.cfg:5``)."""
    af = a.reshape(a.shape[:-2] + (-1,))
    bf = b.reshape(b.shape[:-2] + (-1,))
    a_lo, a_hi = af.amin(-1, keepdim=True), af.amax(-1, keepdim=True)
    b_lo, b_hi = bf.amin(-1, keepdim=True), bf.amax(-1, keepdim=True)
    ta = torch.clamp((af - a_lo) / (a_hi - a_lo + 1e-8) * (n_bins - 1),
                     0, n_bins - 1)
    tb = torch.clamp((bf - b_lo) / (b_hi - b_lo + 1e-8) * (n_bins - 1),
                     0, n_bins - 1)
    centres = torch.arange(n_bins, dtype=torch.float32, device=a.device)
    wa = torch.clamp(1.0 - torch.abs(ta[..., :, None] - centres), min=0.0)
    wb = torch.clamp(1.0 - torch.abs(tb[..., :, None] - centres), min=0.0)
    joint = wa.transpose(-1, -2) @ wb                 # (…, n_bins, n_bins)
    joint = joint / torch.sum(joint, dim=(-2, -1), keepdim=True)
    pa = torch.sum(joint, dim=-1)
    pb = torch.sum(joint, dim=-2)

    def entropy(p, dims):
        # double-where: keep log's argument positive on the dead branch so
        # the gradient stays finite
        keep = p > 1e-12
        safe_p = torch.where(keep, p, torch.ones_like(p))
        return -torch.sum(torch.where(keep, p * torch.log(safe_p),
                                      torch.zeros_like(p)), dim=dims)

    return ((entropy(pa, -1) + entropy(pb, -1))
            / torch.clamp(entropy(joint, (-2, -1)), min=1e-8))
