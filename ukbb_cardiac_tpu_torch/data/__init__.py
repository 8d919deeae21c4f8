"""Data preparation (counterpart of ``ukbb_cardiac_tpu/data``): the
aortic label propagation.  The DICOM, Biobank and cvi42 tools are not
ported yet (ROADMAP A12)."""

from ukbb_cardiac_tpu_torch.data.propagate_aortic import (
    build_propagation_plan,
    infer_time_frame,
    propagate_subject,
    wrap_frame_index,
)
