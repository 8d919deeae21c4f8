"""Utilities: structured timing, device tracing, the kernels' build
directory."""

from ukbb_cardiac_tpu_torch.utils.timing import StageTimer, device_trace
