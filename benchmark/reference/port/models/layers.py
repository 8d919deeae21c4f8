"""Network building blocks: TF-SAME conv, BatchNorm (inference and
training), fixed bilinear upsampling, Glorot-uniform initialisation.

Counterpart of ``ukbb_cardiac_tpu/models/layers.py``.  Activations are
NCHW and kernels OIHW (PyTorch's habit); the arithmetic follows the JAX
package's TF semantics:

- ``tf.layers.conv2d`` 'same' padding: at stride 2 the extra pixel goes
  to the bottom/right.  ``F.conv2d(padding='same')`` rejects stride 2, so
  the padding is applied with ``F.pad``.
- ``tf.layers.batch_normalization``: epsilon 1e-3, normalised in float32
  as ``(x - mean) * (rsqrt(var + eps) * gamma) + beta``.  In training the
  batch statistics normalise (float32, *biased* variance) and the moving
  statistics update as ``m * 0.99 + batch * 0.01``.
  ``F.batch_norm(training=True)`` would update the moving variance with
  the unbiased estimator and the opposite momentum convention, so the
  update is written out here; ``F.batch_norm`` only normalises (one
  fused pass forward and backward instead of about ten elementwise
  ones), and hands the batch statistics over in scratch buffers.
- ``tf.nn.conv2d_transpose`` / ``conv3d_transpose`` ('SAME'): the bundles
  store these kernels already flipped, in correlation orientation, for an
  input-dilated convolution.  Here they run as ``F.conv_transpose2d`` /
  ``F.conv_transpose3d`` with the kernel flipped back and its channel axes
  swapped, the output cropped to the 'SAME' window.
- ``transpose_upsample2d`` with the frozen triangular kernel is the
  separable interpolation ``A_x @ img @ A_y^T``; each row of ``A`` has at
  most two non-zeros.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPSILON = 1e-3  # tf.layers.batch_normalization default
BN_MOMENTUM = 0.99


def glorot_uniform_(weight: torch.Tensor,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Glorot/Xavier uniform in place on an OIHW / OIDHW kernel, drawn
    from ``generator`` (``layers.glorot_uniform``: fan_in = I x receptive
    field, fan_out = O x receptive field, limit sqrt(6 / (in + out)))."""
    receptive = weight[0, 0].numel()
    fan_in = weight.shape[1] * receptive
    fan_out = weight.shape[0] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-limit, limit, generator=generator)


def _same_pad(n: int, k: int, s: int):
    """(lo, hi) TF 'SAME' padding of one axis of size ``n``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """NCHW convolution with TF 'SAME' padding; ``weight`` OIHW, cast to
    the activation dtype (accumulation stays float32 in cuDNN and on the
    CPU)."""
    kh, kw = weight.shape[2:]
    (t, b) = _same_pad(x.shape[2], kh, stride)
    (l, r) = _same_pad(x.shape[3], kw, stride)
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b))
    out = F.conv2d(x, weight.to(x.dtype), stride=stride)
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None, None]
    return out


def conv3d(x: torch.Tensor, weight: torch.Tensor, stride=(1, 1, 1),
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """NCDHW convolution with TF 'SAME' padding; ``weight`` OIDHW."""
    pads = []
    for n, k, s in reversed(list(zip(x.shape[2:], weight.shape[2:],
                                     stride))):
        pads += _same_pad(n, k, s)
    if any(pads):
        x = F.pad(x, pads)
    out = F.conv3d(x, weight.to(x.dtype), stride=tuple(stride))
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1, 1)
    return out


def _conv_transpose(x, weight, stride, conv_transpose):
    """TF 'SAME' transposed convolution from a correlation-orientation
    kernel (O, I, *k): the input-dilated convolution with padding
    ``_same_transpose_padding`` equals ``conv_transpose`` of the kernel
    flipped back and channel-swapped, cropped by the forward 'SAME'
    padding (lo at the start, hi at the end of each axis)."""
    ks = weight.shape[2:]
    w = weight.to(x.dtype).transpose(0, 1).flip(
        list(range(2, weight.dim())))
    out = conv_transpose(x, w, stride=tuple(stride))
    index = [slice(None), slice(None)]
    for k, s, n in zip(ks, stride, out.shape[2:]):
        lo, hi = _same_transpose_padding(k, s)
        index.append(slice(k - 1 - lo, n - (k - 1 - hi)))
    return out[tuple(index)]


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor, stride: int = 2,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """NCHW TF-SAME transposed convolution (output ``stride`` x the input)
    with an OIHW kernel in correlation orientation, as
    ``layers.conv2d_transpose`` applies the bundles' kernels."""
    out = _conv_transpose(x, weight, (stride, stride), F.conv_transpose2d)
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None, None]
    return out


def conv3d_transpose(x: torch.Tensor, weight: torch.Tensor,
                     stride=(1, 2, 2),
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """NCDHW TF-SAME transposed convolution, OIDHW correlation kernel."""
    out = _conv_transpose(x, weight, stride, F.conv_transpose3d)
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1, 1)
    return out


def batch_norm(x: torch.Tensor, gamma, beta, moving_mean,
               moving_variance, train: bool = False,
               ) -> torch.Tensor:
    """BatchNorm over the channel axis (dim 1) of a 4D or 5D input,
    computed in float32 and cast back to the input dtype.

    Inference normalises with the moving statistics.  ``train``
    normalises with the batch's (float32, biased variance; gradients flow
    through both) and updates ``moving_mean`` / ``moving_variance`` in
    place, as ``layers.batch_norm``'s ``new_state``:
    ``m * 0.99 + batch * 0.01``.

    In training ``F.batch_norm`` normalises (float32 statistics for a
    bfloat16 input too) and, at momentum 1, leaves the batch mean and
    the *unbiased* variance in two scratch buffers; the update below
    takes the biased variance, ``unbiased * (n - 1) / n``."""
    if train:
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(moving_mean)
        var = torch.ones_like(moving_variance)
        y = F.batch_norm(x, mean, var, gamma, beta, True, 1.0, BN_EPSILON)
        with torch.no_grad():
            moving_mean.copy_(moving_mean * BN_MOMENTUM
                              + mean * (1 - BN_MOMENTUM))
            moving_variance.copy_(moving_variance * BN_MOMENTUM
                                  + var * ((n - 1) / n) * (1 - BN_MOMENTUM))
        return y
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(moving_variance + BN_EPSILON) * gamma
    y = ((x.float() - moving_mean.view(shape)) * inv.view(shape)
         + beta.view(shape))
    return y.to(x.dtype)


class ConvBN(nn.Module):
    """conv (no bias) -> BN(eval) -> ReLU (``network.py:19-52``); the
    output keeps the input dtype.  ``dims`` 2 or 3; ``transpose`` makes
    the conv a TF-SAME transposed one whose kernel is stored in
    correlation orientation, as in the bundles."""


    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride=1, dims: int = 2, transpose: bool = False):
        super().__init__()
        self.stride = stride
        self.dims = dims
        self.transpose = transpose
        self.weight = nn.Parameter(
            torch.zeros((out_ch, in_ch) + (kernel_size,) * dims))
        self.gamma = nn.Parameter(torch.ones(out_ch))
        self.beta = nn.Parameter(torch.zeros(out_ch))
        self.register_buffer("moving_mean", torch.zeros(out_ch))
        self.register_buffer("moving_variance", torch.ones(out_ch))

    def bn(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return batch_norm(x, self.gamma, self.beta, self.moving_mean,
                          self.moving_variance, train)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        if self.dims == 2:
            fn = conv2d_transpose if self.transpose else conv2d
        else:
            fn = conv3d_transpose if self.transpose else conv3d
        return fn(x, self.weight, self.stride)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), train))


def linear_1d(sz: int) -> np.ndarray:
    """1D triangular interpolation kernel (``network.py:117-124``)."""
    if sz % 2 == 0:
        raise NotImplementedError("`Linear kernel` requires odd filter size.")
    c = (sz + 1) // 2
    h = np.array(list(range(1, c + 1)) + list(range(c - 1, 0, -1)),
                 dtype=np.float32)
    return h / float(c)


def _same_transpose_padding(kernel: int, stride: int):
    """Per-dim (lo, hi) padding of the input-dilated conv equal to TF
    conv2d_transpose(padding='SAME', stride s)."""
    pad_total_fwd = max(kernel - stride, 0)
    fwd_lo = pad_total_fwd // 2
    fwd_hi = pad_total_fwd - fwd_lo
    return (kernel - 1 - fwd_lo, kernel - 1 - fwd_hi)


@functools.lru_cache(maxsize=64)
def _upsample_matrix(n_in: int, factor: int) -> np.ndarray:
    """(n_out, n_in) interpolation matrix equal to TF's 'SAME'
    conv2d_transpose with the 1D triangular kernel of size 2*factor-1.
    Each output row has at most two non-zeros.  Cached and read-only."""
    k = 2 * factor - 1
    h = linear_1d(k).astype(np.float64)
    n_out = n_in * factor
    pad_lo, _ = _same_transpose_padding(k, factor)
    # input-dilated signal: value c[i] at dilated index i*factor;
    # out[x] = sum_j h[j] * dilated[x - pad_lo + j]
    A = np.zeros((n_out, n_in), dtype=np.float32)
    for x in range(n_out):
        for j in range(k):
            d = x - pad_lo + j
            if d % factor == 0:
                i = d // factor
                if 0 <= i < n_in:
                    A[x, i] += h[j]
    A.flags.writeable = False
    return A


_UPSAMPLE_TENSORS = {}


def _upsample_tensor(n_in: int, factor: int, dtype, device) -> torch.Tensor:
    """:func:`_upsample_matrix` as a tensor, made once per (size, factor,
    dtype, device) and kept: an upload inside a training step would wait
    for the card, and a CUDA graph could not hold it.  Made outside
    inference mode (a deploy's first call would otherwise make a tensor
    that a training step's backward cannot save).  Read-only."""
    key = (n_in, factor, dtype, str(device))
    if key not in _UPSAMPLE_TENSORS:
        with torch.inference_mode(False):
            _UPSAMPLE_TENSORS[key] = torch.from_numpy(
                _upsample_matrix(n_in, factor).copy()).to(device=device,
                                                          dtype=dtype)
    return _UPSAMPLE_TENSORS[key]


def transpose_upsample2d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Fixed-bilinear ``factor``x upsampling of NCHW ``x``: TF
    conv2d_transpose('SAME') with the frozen ``linear_2d`` kernel
    (``network.py:138-167``), as ``A_x @ x @ A_y^T``."""
    Ax = _upsample_tensor(x.shape[2], factor, x.dtype, x.device)
    Ay = _upsample_tensor(x.shape[3], factor, x.dtype, x.device)
    return torch.matmul(torch.matmul(Ax, x), Ay.t())
