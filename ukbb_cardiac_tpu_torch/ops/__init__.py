"""Image and array ops: the host (numpy) versions and, where the JAX
package has ``*_jax`` device versions, their ``*_torch`` counterparts
(``normalise_intensity_torch``, ``rescale_intensity_torch``,
``data_augmenter_torch``, ``aortic_batch_augmenter_torch``).

Not re-exported, on purpose: the JAX package's ``*_jax`` augmenters
(``data_augmenter_jax``, ``aortic_data_augmenter_jax``,
``aortic_batch_augmenter_jax``) and intensity functions, whose torch
counterparts are the names above."""

from ukbb_cardiac_tpu_torch.ops.intensity import (
    normalise_intensity,
    normalise_intensity_torch,
    percentiles,
    rescale_intensity,
    rescale_intensity_torch,
)
from ukbb_cardiac_tpu_torch.ops.crop import (
    crop_image,
    foreground_bbox,
    pad_image_to_multiple,
    pad_to_multiple,
    pad_to_size,
)
from ukbb_cardiac_tpu_torch.ops.metrics import (
    categorical_accuracy,
    categorical_dice,
    distance_metric,
    np_categorical_dice,
)
from ukbb_cardiac_tpu_torch.ops.cc import (
    get_largest_cc,
    get_trusted_mask,
    remove_small_cc,
)
from ukbb_cardiac_tpu_torch.ops.augment import (
    aortic_batch_augmenter_torch,
    aortic_data_augmenter,
    data_augmenter,
    data_augmenter_torch,
)
from ukbb_cardiac_tpu_torch.ops.sequence import (
    auto_crop_image,
    image_apply_mask,
    make_sequence,
    padding,
    split_sequence,
    split_volume,
)
from ukbb_cardiac_tpu_torch.ops.resample import (affine_transform_2d,
                                                 sample_2d, warp_image_2d)
