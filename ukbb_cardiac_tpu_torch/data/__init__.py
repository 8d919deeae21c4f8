"""Data acquisition and preparation (counterpart of
``ukbb_cardiac_tpu/data``): UK Biobank DICOM and cvi42 conversion to
NIfTI, training-set preparation, the ``ukbfetch`` download helpers, and
the aortic label propagation."""

from ukbb_cardiac_tpu_torch.data.biobank import (
    BaseImage,
    Biobank_Dataset,
    process_manifest,
)
from ukbb_cardiac_tpu_torch.data.cvi42 import parseFile, parse_workspace
from ukbb_cardiac_tpu_torch.data.dicom import (dcmread, dcmwrite_minimal,
                                               is_dicom_file)
from ukbb_cardiac_tpu_torch.data.prepare import (
    extract_ed_es_frames,
    find_annotated_ed_es,
    link_annotated_subjects,
    link_split,
    quality_control_subjects,
    split_dataset,
)
from ukbb_cardiac_tpu_torch.data.propagate_aortic import (
    build_propagation_plan,
    infer_time_frame,
    propagate_subject,
    wrap_frame_index,
)
