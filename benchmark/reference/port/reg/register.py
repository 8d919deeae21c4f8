"""Multi-level B-spline FFD registration — the MIRTK ``register``
replacement.

Counterpart of ``ukbb_cardiac_tpu/reg/register.py``.  A registration is a
multi-level additive FFD (total displacement = sum of per-level lattices
of halving spacing), optimised with Adam on the control points over a
Gaussian image pyramid, for a whole batch of (target, source) pairs at
once.  Energy as ``par/ffd_cine_2d_motion.cfg``: SSD + 1e-1 bending energy,
3 levels, finest control spacing 10 px (NMI for the aortic config).

Each Adam step is a handful of batched ops, and the B-spline synthesis
inside it (and its adjoint in the backward pass) is the CUDA kernel of
``reg/bspline_field.py`` on the card.  As the JAX package runs a
registration as a few cached jitted programs, the card runs it as CUDA
graphs captured once per shape (``reg/programs.py``): one for the
inputs' mask, normalisation and padding, and one per pyramid level
holding its blur and stride, the finished levels' synthesis and all of
its Adam steps.  The JAX
package's ``'mxu'`` tent-basis warp is a TPU reformulation of the same
bilinear gather: ``RegConfig.warp_backend`` and ``warp_precision`` are
accepted (and the backend name checked) so that a JAX config carries over,
and every backend computes the gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.port import resolve_device
from benchmark.reference.port.ops.resample import sample_2d
from benchmark.reference.port.reg import bspline, losses, programs

WARP_BACKENDS = ("auto", "mxu", "gather")


@dataclass(frozen=True)
class RegConfig:
    spacing: int = 10            # finest control spacing, px (ffd_cine_2d_motion.cfg:11)
    levels: int = 3              # resolution levels (cfg:6 "No. of levels = 3")
    iters: int = 30              # Adam steps per level
    lr: float = 0.5              # px per step at coarse level
    be_weight: float = 1e-1      # bending energy weight (cfg:9)
    metric: str = "ssd"          # 'ssd' | 'nmi' (ffd_aortic_motion.cfg:5)
    n_bins: int = 32             # NMI histogram bins
    smooth_sigma: float = 1.0    # per-level Gaussian blur factor
    padding_value: float | None = None  # ignore-below mask (cfg:12 "Padding value = -1")
    warp_backend: str = "auto"   # 'auto' | 'mxu' | 'gather': all the gather here
    warp_precision: str = "float32"  # accepted for the JAX config's sake; unused

    @staticmethod
    def cine_2d_motion() -> "RegConfig":
        """The ``par/ffd_cine_2d_motion.cfg`` operating point (also
        ``par/ffd_cine_la_2d_motion.cfg``): 3 levels, SSD + 1e-1 bending
        energy, control spacing 10 px."""
        return RegConfig(spacing=10, levels=3, be_weight=1e-1, metric="ssd")

    @staticmethod
    def aortic_motion() -> "RegConfig":
        """The ``par/ffd_aortic_motion.cfg`` operating point: 1 level,
        NMI + 1e-4 bending energy, control spacing 10 px."""
        return RegConfig(spacing=10, levels=1, iters=100, be_weight=1e-4,
                         metric="nmi")


def _gaussian_kernel(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (…, X, Y) images: radius
    ``max(1, int(3σ))``, zero padding, kernel normalised in float32."""
    if sigma <= 0:
        return image
    radius = max(1, int(3 * sigma))
    k = _gaussian_kernel(sigma, radius, image.device)
    X, Y = image.shape[-2:]
    x = image.reshape(-1, 1, X, Y)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1), padding=(radius, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1), padding=(0, radius))
    return x.reshape(image.shape)


def _grid(X: int, Y: int, device):
    gx, gy = torch.meshgrid(torch.arange(X, dtype=torch.float32, device=device),
                            torch.arange(Y, dtype=torch.float32, device=device),
                            indexing="ij")
    return gx, gy


def _bilinear_batch_impl(source, cx, cy):
    """Batched bilinear sampling of (B, X, Y) sources at (B, X, Y)
    coordinates, zero outside (per corner), as one flat gather.  Returns
    the samples and (corners, fractions) for the backward pass.

    The same function as ``ops/resample.sample_2d`` in another float
    order: this one mirrors the JAX ``_bilinear_batch_impl`` (the warp and
    ``invert_field_batch``), ``sample_2d`` mirrors ``map_coordinates``
    (``compose_fields``).  Each keeps its counterpart's rounding, which
    Adam would otherwise magnify."""
    B, X, Y = source.shape
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    fx = cx - x0
    fy = cy - y0
    x0i = x0.long()
    y0i = y0.long()
    sf = source.reshape(-1)
    boff = (torch.arange(B, device=source.device) * (X * Y))[:, None, None]

    def corner(dx, dy):
        xi = x0i + dx
        yi = y0i + dy
        valid = (xi >= 0) & (xi < X) & (yi >= 0) & (yi < Y)
        v = sf[boff + xi.clamp(0, X - 1) * Y + yi.clamp(0, Y - 1)]
        return torch.where(valid, v, torch.zeros_like(v))

    v00, v01 = corner(0, 0), corner(0, 1)
    v10, v11 = corner(1, 0), corner(1, 1)
    out = (v00 * (1 - fx) * (1 - fy) + v01 * (1 - fx) * fy
           + v10 * fx * (1 - fy) + v11 * fx * fy)
    return out, (v00, v01, v10, v11, fx, fy)


class _BilinearConstSrc(torch.autograd.Function):
    """Bilinear sample treating ``source`` as a constant.  The backward is
    elementwise from the four corners the forward gathered (the JAX
    ``_bilinear_bwd``): one-sided differences, so at integer coordinates
    (zero displacement) the gradient is the forward difference.  The
    source gets no gradient."""

    @staticmethod
    def forward(ctx, source, cx, cy):
        out, res = _bilinear_batch_impl(source, cx, cy)
        ctx.save_for_backward(*res)
        return out

    @staticmethod
    def backward(ctx, g):
        v00, v01, v10, v11, fx, fy = ctx.saved_tensors
        dcx = ((v10 - v00) * (1 - fy) + (v11 - v01) * fy) * g
        dcy = ((v01 - v00) * (1 - fx) + (v11 - v10) * fx) * g
        return None, dcx, dcy


def _warp_batch(source: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Batched pull-back warp: out[b, x] = source[b, x + disp[b, x]];
    source (B, X, Y), disp (B, X, Y, 2).  Constant-source gradient."""
    B, X, Y = source.shape
    gx, gy = _grid(X, Y, source.device)
    cx = gx[None] + disp[..., 0]
    cy = gy[None] + disp[..., 1]
    return _BilinearConstSrc.apply(source, cx, cy)


def total_field(controls: Sequence[torch.Tensor],
                image_shape: Tuple[int, int],
                cfg: RegConfig = RegConfig()) -> torch.Tensor:
    """Dense displacement (…, X, Y, 2) of a multi-level control stack;
    each level's lattices may carry leading batch axes."""
    disp = None
    for l, c in enumerate(controls):
        s_l = cfg.spacing * (2 ** (cfg.levels - 1 - l))
        f = bspline.bspline_dense_field(c, image_shape, s_l)
        disp = f if disp is None else disp + f
    return disp


def compose_fields(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Compose pull-back displacement fields (…, X, Y, 2):
    (d1 ∘ d2)(x) = d2(x) + d1(x + d2(x)) — the ``mirtk compose-dofs``
    replacement, with ``sample_2d``'s zero-boundary bilinear sampling."""
    X, Y = d1.shape[-3:-1]
    gx, gy = _grid(X, Y, d1.device)
    px = gx + d2[..., 0]
    py = gy + d2[..., 1]
    d1x = sample_2d(d1[..., 0], px, py)
    d1y = sample_2d(d1[..., 1], px, py)
    return d2 + torch.stack([d1x, d1y], dim=-1)


def invert_field(disp: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Invert one (X, Y, 2) pull-back field by the fixed-point iteration
    v = -u(x + v(x)), ``iters`` times from v = 0, with ``sample_2d``'s
    zero-boundary bilinear sampling (the JAX ``invert_field``)."""
    X, Y, _ = disp.shape
    gx, gy = _grid(X, Y, disp.device)
    v = torch.zeros_like(disp)
    for _ in range(iters):
        px = gx + v[..., 0]
        py = gy + v[..., 1]
        v = -torch.stack([sample_2d(disp[..., 0], px, py),
                          sample_2d(disp[..., 1], px, py)], dim=-1)
    return v


def invert_field_batch(disp: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Invert (B, X, Y, 2) pull-back fields by the fixed-point iteration
    v = -u(x + v(x)), ``iters`` times from v = 0; both displacement
    channels of all B fields sample through one batched gather."""
    B, X, Y, _ = disp.shape
    gx, gy = _grid(X, Y, disp.device)
    srcs = torch.cat([disp[..., 0], disp[..., 1]], dim=0)   # (2B, X, Y)
    v = torch.zeros_like(disp)
    for _ in range(iters):
        px = gx[None] + v[..., 0]
        py = gy[None] + v[..., 1]
        out, _ = _bilinear_batch_impl(srcs, torch.cat([px, px], dim=0),
                                      torch.cat([py, py], dim=0))
        v = -torch.stack([out[:B], out[B:]], dim=-1)
    return v


def compose_chain(pair_fields: torch.Tensor) -> torch.Tensor:
    """Prefix-compose a chain of pull-back pair transforms.

    pair_fields: (…, K, X, Y, 2) where entry k maps frame k → k+1.
    Returns (…, K+1, X, Y, 2): entry t is the 0→t composition (entry 0 the
    identity).  Leading axes are independent chains."""
    K = pair_fields.shape[-4]
    acc = torch.zeros_like(pair_fields.select(-4, 0))
    outs = [acc]
    for k in range(K):
        acc = compose_fields(pair_fields.select(-4, k), acc)
        outs.append(acc)
    return torch.stack(outs, dim=-4)


_CORRECTIONS = {}


def _corrections(steps: int, device) -> torch.Tensor:
    """Adam's bias corrections 1 - decay**count, (steps, 2) float32 for
    count = 1..steps, computed on the host and uploaded once per device:
    a copy per step would wait for the card (and is an error inside a
    graph capture), and a CPU scalar divisor would turn the division into
    a reciprocal multiply on the card."""
    key = (steps, str(device))
    if key not in _CORRECTIONS:
        _CORRECTIONS[key] = torch.stack([torch.stack([
            1 - torch.tensor(d, dtype=torch.float32)
            ** torch.tensor(k, dtype=torch.int32)
            for d in (_Adam.b1, _Adam.b2)])
            for k in range(1, steps + 1)]).to(device)
    return _CORRECTIONS[key]


class _Adam:
    """``optax.adam(lr)`` written out: b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0, bias-corrected, in optax's order of operations."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: torch.Tensor, lr: float, steps: int):
        self.lr = lr
        self.mu = torch.zeros_like(params)
        self.nu = torch.zeros_like(params)
        self.count = 0
        self.corrections = _corrections(steps, params.device)

    def step(self, params: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        b1, b2 = self.b1, self.b2
        self.mu = (1 - b1) * g + b1 * self.mu
        self.nu = (1 - b2) * (g ** 2) + b2 * self.nu
        bc1, bc2 = self.corrections[self.count]
        self.count += 1
        mu_hat = self.mu / bc1
        nu_hat = self.nu / bc2
        updates = mu_hat / (torch.sqrt(nu_hat + 0.0) + self.eps)
        return params + (-self.lr) * updates


def make_register_batch(image_shape: Tuple[int, int],
                        cfg: RegConfig = RegConfig(), device=None):
    """Batched registration: (N, X, Y) targets x sources → per-level
    control stacks (N, Cx_l, Cy_l, 2), each rescaled to full-resolution
    pixels at spacing ``cfg.spacing * factor`` (what :func:`total_field`
    expects).  The returned transform maps target coordinates to source
    coordinates (pull-back).  Runs on ``device`` (default the card).  The
    loss is a sum of per-pair energies, so every pair's Adam path is its
    own."""
    if cfg.metric not in ("ssd", "nmi"):
        raise ValueError(f"unknown metric {cfg.metric!r}")
    if cfg.warp_backend not in WARP_BACKENDS:
        raise ValueError(f"warp_backend must be one of {WARP_BACKENDS}, "
                         f"got {cfg.warp_backend!r}")
    return _register_on(tuple(int(d) for d in image_shape), cfg,
                        resolve_device(device))


def _register_on(image_shape: Tuple[int, int], cfg: RegConfig,
                 dev: torch.device):
    """:func:`make_register_batch`'s optimiser on one device: a program
    for the inputs (mask, normalisation, edge padding), then one per
    pyramid level (``reg/programs.py``)."""
    X, Y = image_shape
    factors = [2 ** (cfg.levels - 1 - l) for l in range(cfg.levels)]
    # pad once so every pyramid level divides exactly (edge replicate —
    # introduces no new intensity extremes)
    f0 = factors[0]
    Xp = -(-X // f0) * f0
    Yp = -(-Y // f0) * f0
    level_shapes = [(Xp // f, Yp // f) for f in factors]
    sigmas = [cfg.smooth_sigma * (f - 1) for f in factors]  # anti-alias blur

    def batch_loss(c, base_disp, tgt, src, mask, l):
        # SUM of the independent per-pair energies: its gradient is the
        # stack of the per-pair gradients
        Xl, Yl = level_shapes[l]
        disp = base_disp + bspline.bspline_dense_field(c, (Xl, Yl),
                                                       cfg.spacing)
        warped = _warp_batch(src, disp)
        if cfg.metric == "nmi":
            sim = -torch.sum(losses.nmi(tgt, warped, cfg.n_bins))
        elif cfg.padding_value is not None:
            sim = torch.sum(losses.ssd(tgt, warped, mask))
        else:
            sim = torch.sum(losses.ssd(tgt, warped))
        be = torch.sum(losses.bending_energy(disp))
        return sim + cfg.be_weight * be

    def synth_prev_levels(prev_controls, l):
        """Displacement of all finished levels, evaluated at level l's
        resolution in its pixel units."""
        Xl, Yl = level_shapes[l]
        base = None
        for m, c_m in enumerate(prev_controls):
            ratio = factors[m] // factors[l]          # ≥ 2, integer
            part = ratio * bspline.bspline_dense_field(
                c_m, (Xl, Yl), cfg.spacing * ratio)
            base = part if base is None else base + part
        return base

    def normalise_pair(targets, sources):
        t32 = targets.float()
        s32 = sources.float()
        lo = torch.amin(t32, dim=(1, 2), keepdim=True)
        scale = torch.clamp(torch.amax(t32, dim=(1, 2), keepdim=True) - lo,
                            min=1e-6)
        return (t32 - lo) / scale, (s32 - lo) / scale

    def pyramid(x, l):
        f, sig = factors[l], sigmas[l]
        if sig > 0:
            x = gaussian_blur(x, sig)
        return x[:, ::f, ::f] if f > 1 else x

    def prepare(targets, sources):
        """(targets, sources) → the normalised, padded pair and the
        target's padding mask, each (B, Xp, Yp)."""
        with torch.no_grad():
            # MIRTK's "Padding value": voxels at/below it in the TARGET are
            # excluded from the similarity (par/ffd_cine_2d_motion.cfg:12)
            thresh = (cfg.padding_value if cfg.padding_value is not None
                      else float("-inf"))
            mask_full = (targets.float() > thresh).float()
            tgt_n, src_n = normalise_pair(targets, sources)
            if (Xp, Yp) != (X, Y):
                pad = (0, Yp - Y, 0, Xp - X)
                tgt_n, src_n, mask_full = (
                    F.pad(t[:, None], pad, mode="replicate")[:, 0]
                    for t in (tgt_n, src_n, mask_full))
        return tgt_n, src_n, mask_full

    def level_program(l):
        """Level l's program: (tgt_n, src_n, mask_full, *finished
        lattices) → (its lattice,) after all of its Adam steps, the JAX
        ``step_block``'s one dispatch (with the level's blur and stride and
        ``synth_prev_levels``)."""
        Xl, Yl = level_shapes[l]
        f = factors[l]
        Cx, Cy = bspline.lattice_shape((Xl, Yl), cfg.spacing)

        def program(tgt_n, src_n, mask_full, *prev):
            B = tgt_n.shape[0]
            with torch.no_grad():
                tgt_l = pyramid(tgt_n, l)
                src_l = pyramid(src_n, l)
                mask_l = mask_full[:, ::f, ::f] if f > 1 else mask_full
                base = (synth_prev_levels(prev, l) if prev
                        else torch.zeros((B, Xl, Yl, 2), device=tgt_n.device))
            c = torch.zeros((B, Cx, Cy, 2), device=tgt_n.device)
            opt = _Adam(c, cfg.lr, cfg.iters)
            for _ in range(cfg.iters):
                with torch.enable_grad():
                    c_req = c.detach().requires_grad_(True)
                    loss = batch_loss(c_req, base, tgt_l, src_l, mask_l, l)
                    (g,) = torch.autograd.grad(loss, c_req)
                with torch.no_grad():
                    c = opt.step(c, g)
            return (c,)

        return program

    levels = [level_program(l) for l in range(cfg.levels)]

    # the optimiser records autograd whatever mode the caller entered:
    # inference mode (the deploy engine's) would make every tensor made
    # here an inference tensor, which autograd refuses
    @torch.inference_mode(False)
    def register(targets, sources):
        targets = torch.as_tensor(targets, device=dev)
        sources = torch.as_tensor(sources, device=dev)
        if targets.shape[0] == 0:
            raise ValueError("empty registration batch: no frame pairs")
        tgt_n, src_n, mask_full = programs.run(
            ("register-inputs", cfg), prepare, targets, sources)
        controls = []
        for l in range(cfg.levels):
            controls += programs.run(("register-level", l, cfg), levels[l],
                                     tgt_n, src_n, mask_full, *controls)
        return tuple(c * f for c, f in zip(controls, factors))

    return register
