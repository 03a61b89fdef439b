"""PyTorch models, each split into a *backbone* producing the FDS hook (the
age ResNet's pooled encoding, the NYUD2 encoder-decoder's per-pixel map) and
a *head* mapping (possibly FDS-calibrated) encodings to predictions."""

from imbalanced_regression_tpu_torch.models.resnet import ResNetBackbone, RegressionHead, resnet50_backbone  # noqa: F401
from imbalanced_regression_tpu_torch.models.depth_encdec import DepthEncoderDecoder, DepthHead, depth_feature_dim  # noqa: F401
