"""Image ops: intensity rescaling and z-scoring (host and device), deploy
padding."""

from ukbb_cardiac_tpu_torch.ops.crop import pad_to_multiple, pad_to_size
from ukbb_cardiac_tpu_torch.ops.intensity import (
    normalise_intensity,
    normalise_intensity_torch,
    percentiles,
    rescale_intensity,
    rescale_intensity_torch,
)
