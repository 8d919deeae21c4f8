"""Fused FCN multiscale head (inference): CUDA kernel and plain version.

Counterpart of ``ukbb_cardiac_tpu/models/pallas_head.py``.  Per slice it
computes, with every BatchNorm folded into its 1x1 conv:

1. each level's same-dim projection ``relu(f_l @ Wsd_l + bsd_l)``;
2. bilinear x2^l upsampling of levels 1.. through the ``_upsample_matrix``
   interpolation matrices;
3. fc1 over the n_level*same_dim channels, ReLU; fc2, ReLU;
4. the 1x1 output conv plus bias,

and returns channels-first float32 logits (N, n_class, X, Y).

:func:`fused_head` launches ``csrc/fused_head.cu`` on a CUDA tensor and
takes :func:`fused_head_plain` on a CPU tensor; nothing falls back.
Features may be float32 or bfloat16; weights and accumulation are
float32.  Inference only, like the TPU kernel (no gradient).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ukbb_cardiac_tpu_torch.models import layers as L
from ukbb_cardiac_tpu_torch.models.fcn import FCN, nchw

# What csrc/fused_head.cu is compiled for (SD, FC, NCP, MAX_LEVEL, TILE
# and CTILE there).
KERNEL_SAME_DIM = 32
KERNEL_FC = 64
KERNEL_CLASS_PAD = 8
KERNEL_MAX_LEVEL = 5
KERNEL_TILE = 128          # level-0 pixels per staged tile
KERNEL_COARSE_TILE = 64    # coarse-level pixels per staged tile


def fold_conv_bn(weight: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, moving_mean: torch.Tensor,
                 moving_variance: torch.Tensor):
    """Fold an inference-mode BatchNorm into a bias-free 1x1 conv.

    conv -> BN(eval) == conv with a scaled kernel plus a bias:
      scale = gamma / sqrt(var + eps);  W' = W * scale;
      b' = beta - moving_mean * scale.
    ``weight`` is OIHW (Cout, Cin, 1, 1).  Returns (W (Cin, Cout), b).
    """
    W = weight.detach().float()[:, :, 0, 0].t()
    scale = gamma.detach().float() * torch.rsqrt(
        moving_variance.detach().float() + L.BN_EPSILON)
    bias = beta.detach().float() - moving_mean.detach().float() * scale
    return (W * scale[None, :]).contiguous(), bias


# Rows of a chained product's weight within each block of 8: the mma
# fragment's A column t takes the previous product's C column 2t, and A
# column t+4 takes C column 2t+1 (csrc/fused_head.cu, "Fragments").
CHAIN_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def tf32_round(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: float32 rounded to TF32's 10 mantissa bits,
    to nearest with ties away from zero (the 13 dropped bits)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tf32(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """x -> (hi, lo), both TF32 values: hi = rna(x), lo = rna(x - hi)."""
    x = np.asarray(x, dtype=np.float32)
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def weight_fragments(W: np.ndarray, chained: bool) -> np.ndarray:
    """A (K, N) float32 weight in the order the kernel's m16n8k8 B
    fragments read it: (K/8, N/8, 32 lanes, 4) with lane 4g + t holding
    {hi b0, hi b1, lo b0, lo b1}, b0 = W[8kb + r(t), 8nb + g] and
    b1 = W[8kb + r(t + 4), 8nb + g].  r is the identity for a product fed
    by staged features and CHAIN_ORDER for one fed by the previous
    product's accumulators.  K is zero-padded to a multiple of 8; N must
    be one."""
    K, N = W.shape
    if N % 8:
        raise ValueError(f"fragment columns must be a multiple of 8, got {N}")
    Kp = -(-K // 8) * 8
    Wp = np.zeros((Kp, N), np.float32)
    Wp[:K] = W
    if chained:
        Wp = Wp.reshape(Kp // 8, 8, N)[:, CHAIN_ORDER].reshape(Kp, N)
    hi, lo = split_tf32(Wp)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    kb, nb = np.arange(Kp // 8), np.arange(N // 8)
    rows = kb[:, None, None] * 8 + t[None, None, :]          # (KB, 1, 32)
    cols = nb[None, :, None] * 8 + g[None, None, :]          # (1, NB, 32)
    return np.stack([hi[rows, cols], hi[rows + 4, cols],
                     lo[rows, cols], lo[rows + 4, cols]], axis=-1)


def tf32_round_torch(x: torch.Tensor) -> torch.Tensor:
    """:func:`tf32_round` as integer bit operations on an int32 view, on
    ``x``'s device (two's complement: the same bits as the uint32 sum)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def weight_fragments_torch(W: torch.Tensor, chained: bool) -> torch.Tensor:
    """:func:`weight_fragments` as torch ops on ``W``'s device, bitwise
    the host's: the zero padding, CHAIN_ORDER (within each block of 8
    rows, the even rows then the odd) and the lane order are views and
    permutes, the TF32 split :func:`tf32_round_torch`."""
    K, N = W.shape
    if N % 8:
        raise ValueError(f"fragment columns must be a multiple of 8, got {N}")
    Kp = -(-K // 8) * 8
    Wp = torch.nn.functional.pad(W.float(), (0, 0, 0, Kp - K))
    if chained:
        Wp = Wp.view(Kp // 8, 4, 2, N).transpose(1, 2).reshape(Kp, N)
    hi = tf32_round_torch(Wp)
    lo = tf32_round_torch(Wp - hi)

    def lanes(x, half):
        # (KB, NB, 32): lane 4g + t holds x[8kb + 4 half + t, 8nb + g]
        x = x.view(Kp // 8, 8, N // 8, 8)[:, 4 * half:4 * half + 4]
        return x.permute(0, 2, 3, 1).reshape(Kp // 8, N // 8, 32)

    return torch.stack([lanes(hi, 0), lanes(hi, 1), lanes(lo, 0),
                        lanes(lo, 1)], dim=-1)


_TAPS: Dict = {}


def _tap_tables(n_level: int, X: int, Y: int, device):
    """The bilinear tap tables of :meth:`HeadWeights.taps`, made once per
    (levels, X, Y, device) and kept (read-only)."""
    key = (n_level, X, Y, str(device))
    if key not in _TAPS:
        idx, wts = [], []
        for l in range(1, n_level):
            for n_out in (X, Y):
                A = L._upsample_matrix(n_out >> l, 2 ** l)
                for row in A:
                    nz = np.flatnonzero(row)
                    if not 1 <= len(nz) <= 2:
                        raise ValueError(f"upsample row with {len(nz)} taps")
                    i0, i1 = nz[0], nz[-1]
                    idx.append((i0, i1))
                    wts.append((row[i0], row[i1] if i1 != i0 else 0.0))
        _TAPS[key] = (torch.tensor(idx, dtype=torch.int32, device=device),
                      torch.tensor(wts, dtype=torch.float32, device=device))
    return _TAPS[key]


@dataclass
class HeadWeights:
    """The head's folded float32 weights, and the kernel's copies of them.

    ``Wsd[l]`` (C_l, same_dim), ``W1`` (n_level*same_dim, fc),
    ``W2`` (fc, fc), ``Wout`` (fc, n_class); biases 1-D.
    """

    Wsd: List[torch.Tensor]
    bsd: List[torch.Tensor]
    W1: torch.Tensor
    b1: torch.Tensor
    W2: torch.Tensor
    b2: torch.Tensor
    Wout: torch.Tensor
    bout: torch.Tensor
    _dev: Dict = field(default_factory=dict, repr=False)

    @property
    def n_level(self) -> int:
        return len(self.Wsd)

    @property
    def n_class(self) -> int:
        return self.Wout.shape[1]

    @property
    def same_dim(self) -> int:
        return self.Wsd[0].shape[1]

    def packed(self, device) -> torch.Tensor:
        """One float32 buffer in the order ``csrc/fused_head.cu`` reads:
        the head block [Wsd_0, W1_0, W2, Wout] as tensor-core fragments
        (:func:`weight_fragments`; the chained products' rows permuted),
        then [bsd_0, b1, b2, bout] (the class axis zero-padded to
        KERNEL_CLASS_PAD); then [Wsd_l, W1_l] as fragments and bsd_l for
        each coarse level l = 1 .. n_level-1, where W1_l is fc1's
        (same_dim, fc) block of rows for level l."""
        key = ("packed", str(device))
        if key not in self._dev:
            nc, pad = self.n_class, KERNEL_CLASS_PAD
            Wout = np.zeros((self.Wout.shape[0], pad), np.float32)
            Wout[:, :nc] = _np(self.Wout)
            bout = np.zeros(pad, np.float32)
            bout[:nc] = _np(self.bout)
            sd = self.same_dim
            W1 = _np(self.W1)
            parts = [weight_fragments(_np(self.Wsd[0]), chained=False),
                     weight_fragments(W1[:sd], chained=True),
                     weight_fragments(_np(self.W2), chained=True),
                     weight_fragments(Wout, chained=True),
                     _np(self.bsd[0]), _np(self.b1), _np(self.b2), bout]
            for l in range(1, self.n_level):
                parts += [weight_fragments(_np(self.Wsd[l]), chained=False),
                          weight_fragments(W1[l * sd:(l + 1) * sd],
                                           chained=True),
                          _np(self.bsd[l])]
            flat = np.concatenate([p.reshape(-1) for p in parts])
            self._dev[key] = torch.from_numpy(flat).to(device)
        return self._dev[key]

    def pack_on_device(self) -> torch.Tensor:
        """:meth:`packed`'s buffer made by torch ops on the weights' own
        device (:func:`weight_fragments_torch`), bitwise the host's
        packing, and kept as these weights' packing for that device.
        Nothing goes through the host, so a CUDA graph can hold it: the
        trainer's validation program folds and packs the live
        parameters every call (``train/sa.py``)."""
        nc, pad = self.n_class, KERNEL_CLASS_PAD
        Wout = torch.nn.functional.pad(self.Wout.float(), (0, pad - nc))
        bout = torch.nn.functional.pad(self.bout.float(), (0, pad - nc))
        sd = self.same_dim
        parts = [weight_fragments_torch(self.Wsd[0], chained=False),
                 weight_fragments_torch(self.W1[:sd], chained=True),
                 weight_fragments_torch(self.W2, chained=True),
                 weight_fragments_torch(Wout, chained=True),
                 self.bsd[0], self.b1, self.b2, bout]
        for l in range(1, self.n_level):
            parts += [weight_fragments_torch(self.Wsd[l], chained=False),
                      weight_fragments_torch(self.W1[l * sd:(l + 1) * sd],
                                             chained=True),
                      self.bsd[l]]
        flat = torch.cat([p.float().reshape(-1) for p in parts])
        self._dev[("packed", str(flat.device))] = flat
        return flat

    def taps(self, X: int, Y: int, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """Bilinear tap tables for an (X, Y) level-0 grid: for each coarse
        level l = 1.., X entries then Y entries of (index0, index1) int32
        and (weight0, weight1) float32 — the non-zeros of each row of
        ``_upsample_matrix`` (at most two; a missing one has weight 0).
        Shared by every head of as many levels on the device."""
        return _tap_tables(self.n_level, X, Y, device)


def fold_head(net: FCN) -> HeadWeights:
    """Fold every BN of the head of an FCN or a ResNet-FCN (they share it)
    into its 1x1 conv (float32, on the net's device).  The result holds
    the weights as they are now: after a training update, fold again."""
    Wsd, bsd = [], []
    for unit in net.same_dim:
        W, b = fold_conv_bn(unit.weight, unit.gamma, unit.beta,
                            unit.moving_mean, unit.moving_variance)
        Wsd.append(W)
        bsd.append(b)
    fc1, fc2 = net.fc
    W1, b1 = fold_conv_bn(fc1.weight, fc1.gamma, fc1.beta, fc1.moving_mean,
                          fc1.moving_variance)
    W2, b2 = fold_conv_bn(fc2.weight, fc2.gamma, fc2.beta, fc2.moving_mean,
                          fc2.moving_variance)
    Wout = net.out.weight.detach().float()[:, :, 0, 0].t().contiguous()
    bout = net.out.bias.detach().float().clone()
    return HeadWeights(Wsd, bsd, W1, b1, W2, b2, Wout, bout)


def _project(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(N, C, X, Y) x (C, D) -> (N, D, X, Y), float32."""
    return torch.einsum("ncxy,cd->ndxy", x, W)


def fused_head_plain(feats: Sequence[torch.Tensor],
                     w: HeadWeights) -> torch.Tensor:
    """The plain PyTorch version: same function as the kernel, every step
    in float32.  ``feats`` are NCHW per-level features, level 0 at full
    size; returns logits (N, n_class, X, Y) float32."""
    sd = w.same_dim
    acc = None
    for l, f in enumerate(feats):
        y = torch.relu(_project(f.float(), w.Wsd[l])
                       + w.bsd[l][None, :, None, None])
        if l > 0:
            y = L.transpose_upsample2d(y, 2 ** l)
        part = _project(y, w.W1[l * sd:(l + 1) * sd])
        acc = part if acc is None else acc + part
    z = torch.relu(acc + w.b1[None, :, None, None])
    z = torch.relu(_project(z, w.W2) + w.b2[None, :, None, None])
    return _project(z, w.Wout) + w.bout[None, :, None, None]


def _check(feats: Sequence[torch.Tensor], w: HeadWeights) -> None:
    if len(feats) != w.n_level:
        raise ValueError(f"expected {w.n_level} feature levels, "
                         f"got {len(feats)}")
    f0 = feats[0]
    if f0.dim() != 4:
        raise ValueError(f"features must be NCHW, got shape {tuple(f0.shape)}")
    N, _, X, Y = f0.shape
    if X % (1 << (w.n_level - 1)) or Y % (1 << (w.n_level - 1)):
        raise ValueError(f"(X, Y) = ({X}, {Y}) must be multiples of "
                         f"{1 << (w.n_level - 1)}")
    for l, f in enumerate(feats):
        want = (N, w.Wsd[l].shape[0], X >> l, Y >> l)
        if tuple(f.shape) != want:
            raise ValueError(f"level {l} features have shape "
                             f"{tuple(f.shape)}, expected {want}")
        if f.device != f0.device or f.dtype != f0.dtype:
            raise ValueError("all feature levels must share device and dtype")
        if not f.is_contiguous():
            raise ValueError(f"level {l} features are not contiguous NCHW")
    if f0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be float32 or bfloat16, "
                        f"got {f0.dtype}")


def _check_kernel_shapes(feats, w: HeadWeights) -> None:
    if (w.same_dim, w.W1.shape[1]) != (KERNEL_SAME_DIM, KERNEL_FC):
        raise ValueError(
            f"the CUDA head is built for same_dim={KERNEL_SAME_DIM}, "
            f"fc={KERNEL_FC}; got {w.same_dim}, {w.W1.shape[1]}")
    if w.n_class > KERNEL_CLASS_PAD or w.n_level > KERNEL_MAX_LEVEL:
        raise ValueError(f"the CUDA head takes at most {KERNEL_CLASS_PAD} "
                         f"classes and {KERNEL_MAX_LEVEL} levels")
    if feats[0][:, 0].numel() >= 2 ** 31:
        raise ValueError("too many pixels for the kernel's 32-bit indices")


def fused_head(feats: Sequence[torch.Tensor], w: HeadWeights) -> torch.Tensor:
    """Fused head: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors.  ``fused_head.launches`` counts kernel launches: a call
    launches one ``coarse_kernel`` per coarse level and one
    ``head_kernel``, ``n_level`` in all; ``fused_head.launches_by_class``
    splits the same count by the head's number of classes."""
    _check(feats, w)
    dev = feats[0].device
    if dev.type == "cpu":
        return fused_head_plain(feats, w)
    if dev.type != "cuda":
        raise ValueError(f"fused_head runs on cuda or cpu, not {dev}")
    _check_kernel_shapes(feats, w)
    from ukbb_cardiac_tpu_torch import kernels

    lib = kernels.load("fused_head")
    N, _, X, Y = feats[0].shape
    packed = w.packed(dev)
    tap_idx, tap_w = w.taps(X, Y, dev)
    n_scratch = sum(N * (X >> l) * (Y >> l) * KERNEL_FC
                    for l in range(1, w.n_level))
    scratch = torch.empty(max(n_scratch, 1), dtype=torch.float32, device=dev)
    out = torch.empty((N, w.n_class, X, Y), dtype=torch.float32, device=dev)
    ptrs = [f.data_ptr() for f in feats] + [None] * (KERNEL_MAX_LEVEL
                                                      - len(feats))
    chans = [f.shape[1] for f in feats] + [0] * (KERNEL_MAX_LEVEL
                                                 - len(feats))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ukbb_fused_head(
            int(feats[0].dtype == torch.bfloat16), w.n_level, N, X, Y,
            w.n_class, *ptrs, *chans, packed.data_ptr(), tap_idx.data_ptr(),
            tap_w.data_ptr(), scratch.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_head kernel failed: CUDA error {rc} "
                           f"({kernels.error_string(lib, rc)})")
    kernels.count_launches(fused_head, w.n_level, n_class=w.n_class)
    return out


fused_head.launches = 0
fused_head.launches_by_class = {}


def apply_fcn_fused(net: FCN, image: torch.Tensor, head: HeadWeights = None,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """FCN / ResNet-FCN forward: encoder (``F.conv2d``) + fused head.  ``image`` is
    (N, X, Y, C); returns channels-first logits (N, n_class, X, Y)
    float32 — take ``argmax(dim=1)`` for predictions.  Counterpart of
    ``apply_fcn_pallas``."""
    if head is None:
        head = fold_head(net)
    # a channels-last net (the trainer's) gives channels-last features;
    # the kernel reads contiguous NCHW (a no-op for a deployed net)
    feats = [f.contiguous() for f in net.encode(nchw(image, compute_dtype))]
    return fused_head(feats, head)

