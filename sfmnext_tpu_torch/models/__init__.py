from sfmnext_tpu_torch.models.decoder_bn import (  # noqa: F401
    DecoderBN,
    ResnetEncoderDecoder,
    UpSampleBN,
)
from sfmnext_tpu_torch.models.pose_cnn import PoseCNN  # noqa: F401
from sfmnext_tpu_torch.models.resnet import ResNetEncoder  # noqa: F401
from sfmnext_tpu_torch.models.sql_decoder import SQLDecoder  # noqa: F401
