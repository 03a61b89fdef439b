"""PyTorch models, each split into a *backbone* producing the FDS hook (the
age ResNet's pooled encoding, the NYUD2 encoder-decoder's per-pixel map, the
STS-B pair embedding of the BiLSTM or of DeepSeek-V2) and a *head* mapping
(possibly FDS-calibrated) encodings to predictions."""

from imbalanced_regression_tpu_torch.models.resnet import (  # noqa: F401
    RegressionHead,
    ResNetBackbone,
    ResNetBasicBackbone,
    resnet18_backbone,
    resnet34_backbone,
    resnet50_backbone,
    resnet101_backbone,
    resnet152_backbone,
)
from imbalanced_regression_tpu_torch.models.depth_encdec import DepthEncoderDecoder, DepthHead, depth_feature_dim  # noqa: F401
from imbalanced_regression_tpu_torch.models.bilstm_pair import PairBiLSTMEncoder  # noqa: F401
from imbalanced_regression_tpu_torch.models.deepseek_v2 import PairMoEEncoder  # noqa: F401
