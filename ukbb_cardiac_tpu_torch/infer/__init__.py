"""Batched deployment engines on the card: the SA/LA slice engine, the
aortic engine, and the per-subject deploy functions."""

from ukbb_cardiac_tpu_torch.infer.engine import (
    InferenceEngine,
    PendingSegmentation,
    SegmentationModel,
    pad_to_factor,
)
from ukbb_cardiac_tpu_torch.infer.deploy import (
    deploy_dataset,
    deploy_subject_ed_es,
    deploy_subject_sequence,
    es_frame,
    load_segmentation_model,
)
from ukbb_cardiac_tpu_torch.infer.deploy_ao import (
    AorticEngine,
    deploy_dataset_ao,
    deploy_subject_ao,
    load_aortic_engine,
    window_weights,
)
