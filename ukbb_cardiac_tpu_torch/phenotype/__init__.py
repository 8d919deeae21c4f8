"""Clinical phenotypes computed from segmentations: volumes, areas, wall
thickness, atrial and aortic measures, and strain (``strain``,
``strain_la``, imported on their own)."""

from ukbb_cardiac_tpu_torch.phenotype.aha import (
    determine_aha_coordinate_system,
    determine_aha_part,
    determine_aha_segment_id,
    determine_aha_segment_ids,
)
from ukbb_cardiac_tpu_torch.phenotype.aorta import (
    aortic_area_measures,
    evaluate_aortic_area_dataset,
    load_central_pulse_pressure,
)
from ukbb_cardiac_tpu_torch.phenotype.atrium import (
    atrial_volume_measures,
    evaluate_atrial_area_length,
    evaluate_atrial_volume_dataset,
)
from ukbb_cardiac_tpu_torch.phenotype.bullseye import (bulls_eye_canvas,
                                                       plot_bulls_eye)
from ukbb_cardiac_tpu_torch.phenotype.contours import (approximate_contour,
                                                       extract_contour)
from ukbb_cardiac_tpu_torch.phenotype.qc import (
    aorta_pass_quality_control,
    atrium_pass_quality_control,
    la_pass_quality_control,
    sa_pass_quality_control,
)
from ukbb_cardiac_tpu_torch.phenotype.ventricle import (
    evaluate_ventricular_volume_dataset,
    ventricular_volume_measures,
)
from ukbb_cardiac_tpu_torch.phenotype.wall_thickness import \
    evaluate_wall_thickness
