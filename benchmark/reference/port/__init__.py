"""A frozen copy of the plain paths of ``ukbb_cardiac_tpu_torch``.

The benchmark's reference for the cohort cells: the modules that the SA
chain (segmentation, volumes, strain) and the aortic stage run, copied
from ``ukbb_cardiac_tpu_torch`` with their imports pointed here and every
route that is not plain PyTorch or NumPy taken out:

- ``reg/programs.py`` runs each program eagerly (no CUDA graph);
- ``reg/bspline.py::bspline_dense_field`` is the two-einsum synthesis,
  differentiated by autograd (no ``csrc/bspline_field.cu``);
- ``ops/cc.py`` labels components with scipy (no native library);
- ``resolve_device`` leaves TF32 as the caller set it, so that the
  control can turn it on;
- the FCN forward is the module's own concat head (no ``csrc/fused_head.cu``).

Only the single-device eager path that ``reference/fcn_sa.py`` and
``reference/unet_lstm_ao.py`` call is kept: no mesh, no factory caches, no
per-frame contour files, no warp-Dice, no training losses and no other
model kinds.  The volume and area stages are not copied: they are
written out from the published scripts in ``reference/stages.py``.

Copied from ``ukbb_cardiac_tpu_torch`` as of commit 69eba47, whose tests
hold each module against the JAX package on the CPU
(``tests/test_torch_*.py``: data, strain, fcn, unet, hostops, intensity,
reg, bspline).

Nothing here imports the port, so a change to the port cannot move it.
It is the yardstick: edit it only in a benchmark change.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(name: str | None = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means ``"cuda"``.  A CUDA device without a card raises: the
    CPU is used only when the caller names it.  The precision is the
    caller's (``reference/fcn_sa.py::set_precision``).
    """
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device 'cpu' (--device cpu) to run "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev
