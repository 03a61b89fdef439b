"""PyTorch models: the ResNet regressor of the age suites, split into a
*backbone* producing the penultimate encoding and a *head* mapping (possibly
FDS-calibrated) encodings to predictions."""

from imbalanced_regression_tpu_torch.models.resnet import ResNetBackbone, RegressionHead, resnet50_backbone  # noqa: F401
