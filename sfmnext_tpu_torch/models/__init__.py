from sfmnext_tpu_torch.models.decoder_bn import (  # noqa: F401
    DecoderBN,
    LiteResnetEncoderDecoder,
    ResnetEncoderDecoder,
    UpSampleBN,
)
from sfmnext_tpu_torch.models.pose_cnn import PoseCNN  # noqa: F401
from sfmnext_tpu_torch.models.pose_decoder import PoseDecoder  # noqa: F401
from sfmnext_tpu_torch.models.predictive_mask import PredictiveMask  # noqa: F401
from sfmnext_tpu_torch.models.rectify import RectifyNet, RotDecoder  # noqa: F401
from sfmnext_tpu_torch.models.resnet import ResNetEncoder  # noqa: F401
from sfmnext_tpu_torch.models.sql_decoder import SQLDecoder  # noqa: F401
