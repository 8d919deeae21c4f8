"""Model zoo: the FCN and ResNet-FCN (with the fused head, a CUDA kernel),
the U-Net and temporal U-Net, the (bidirectional) ConvLSTM heads, and
TransUNet R50-ViT-B/16 (an SA segmenter of the port alone), as
``nn.Module``s with the JAX package's ``apply_*`` functions beside them.

Not re-exported, on purpose: the JAX package's PRNG-key initialisers
``init_fcn``, ``init_resnet``, ``init_unet``, ``init_conv_lstm`` and
``init_biconv_lstm`` (the modules here initialise themselves;
``init_weights`` re-draws an FCN's), and ``apply_resnet`` (``apply_fcn``
takes a :class:`ResNetFCN` as well)."""

from ukbb_cardiac_tpu_torch.models.fcn import (
    FCN,
    FCNConfig,
    ResNetConfig,
    ResNetFCN,
    apply_fcn,
    init_weights,
    prob_and_pred,
)
from ukbb_cardiac_tpu_torch.models.unet import (
    UNet,
    UNetConfig,
    apply_temporal_unet,
    apply_unet,
)
from ukbb_cardiac_tpu_torch.models.convlstm import (
    BiConvLSTM,
    ConvLSTM,
    apply_biconv_lstm,
    apply_conv_lstm,
)
from ukbb_cardiac_tpu_torch.models.transunet import (
    TransUNet,
    TransUNetConfig,
)
from ukbb_cardiac_tpu_torch.models import losses, wrappers
