"""Convolutional LSTM heads for temporally consistent aortic segmentation.

Counterpart of ``ukbb_cardiac_tpu/models/convlstm.py``
(``common/network_ao.py`` ``Conv_LSTM``, ``BiConv_LSTM``).  The cell is
TF's ConvLSTMCell: one conv over ``concat([x, h])`` giving 4 * n_hidden
channels in gate order (input, new input, forget, output), forget bias
1.0:

    c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(j);  h' = tanh(c') * sigmoid(o)

``h`` is cast to the input's dtype before the concat; ``c`` stays float32.
The JAX package scans the cell with ``lax.scan``; here :func:`scan_cell`
is a loop over T, one step per frame (per direction).  The aortic deploy
captures the whole scan, 2 x T steps, in its full-sequence CUDA graph
and replays it as one launch (``infer/deploy_ao.py``,
``reg/programs.py``); the aortic trainer runs the loop eagerly.

NCHW inside: a sequence is (N, T, C, X, Y).
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.port.models import layers as L

FORGET_BIAS = 1.0


class ConvLSTMCell(nn.Module):
    """Cell weights: an OIHW kernel (4 * n_hidden, in_ch + n_hidden, k, k)
    and its biases."""

    def __init__(self, in_ch: int, n_hidden: int, kernel_size: int = 3):
        super().__init__()
        self.n_hidden = n_hidden
        self.weight = nn.Parameter(torch.zeros(
            4 * n_hidden, in_ch + n_hidden, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(4 * n_hidden))

    def forward(self, x, c, h):
        return convlstm_cell(self, x, c, h)


def convlstm_cell(cell: ConvLSTMCell, x: torch.Tensor, c: torch.Tensor,
                  h: torch.Tensor):
    """One ConvLSTM step. x: (N, C, X, Y); c, h: (N, n_hidden, X, Y)."""
    xh = torch.cat([x, h.to(x.dtype)], dim=1)
    gates = L.conv2d(xh, cell.weight, bias=cell.bias)
    i, j, f, o = torch.chunk(gates, 4, dim=1)
    c_new = (torch.sigmoid(f + FORGET_BIAS) * c
             + torch.sigmoid(i) * torch.tanh(j))
    h_new = torch.tanh(c_new) * torch.sigmoid(o)
    return c_new, h_new


def scan_cell(cell: ConvLSTMCell, features: torch.Tensor,
              reverse: bool = False, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Run the cell over time. features: (N, T, C, X, Y) -> hidden states
    (N, T, n_hidden, X, Y) float32, frame t's state at index t in either
    direction.  ``out``: a view of that shape to write into."""
    N, T, _, X, Y = features.shape
    c = features.new_zeros((N, cell.n_hidden, X, Y), dtype=torch.float32)
    h = torch.zeros_like(c)
    if out is None:
        out = c.new_empty((N, T, cell.n_hidden, X, Y))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        c, h = convlstm_cell(cell, features[:, t], c, h)
        out[:, t] = h
    return out


def _output_conv(hs: torch.Tensor, weight, bias) -> torch.Tensor:
    N, T = hs.shape[:2]
    logits = L.conv2d(hs.flatten(0, 1), weight, bias=bias)
    return logits.view(N, T, *logits.shape[1:]).float()


class ConvLSTM(nn.Module):
    """Unidirectional head (``network_ao.py:214-252``): the cell, then a
    1x1 logits conv per frame."""

    def __init__(self, in_ch: int, n_hidden: int, n_class: int):
        super().__init__()
        self.cell = ConvLSTMCell(in_ch, n_hidden)
        self.out_weight = nn.Parameter(torch.zeros(n_class, n_hidden, 1, 1))
        self.out_bias = nn.Parameter(torch.zeros(n_class))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """(N, T, C, X, Y) features -> (N, T, n_class, X, Y) f32 logits."""
        return _output_conv(scan_cell(self.cell, features), self.out_weight,
                            self.out_bias)


class BiConvLSTM(nn.Module):
    """Bidirectional head (``network_ao.py:255-319``): forward and backward
    cells, their hidden states at frame t concatenated, one shared 1x1
    logits conv."""

    def __init__(self, in_ch: int, n_hidden: int, n_class: int):
        super().__init__()
        self.forward_cell = ConvLSTMCell(in_ch, n_hidden)
        self.backward_cell = ConvLSTMCell(in_ch, n_hidden)
        self.out_weight = nn.Parameter(
            torch.zeros(n_class, 2 * n_hidden, 1, 1))
        self.out_bias = nn.Parameter(torch.zeros(n_class))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """(N, T, C, X, Y) features -> (N, T, n_class, X, Y) f32 logits."""
        N, T, _, X, Y = features.shape
        H = self.forward_cell.n_hidden
        hs = features.new_empty((N, T, 2 * H, X, Y), dtype=torch.float32)
        scan_cell(self.forward_cell, features, out=hs[:, :, :H])
        scan_cell(self.backward_cell, features, reverse=True,
                  out=hs[:, :, H:])
        return _output_conv(hs, self.out_weight, self.out_bias)
