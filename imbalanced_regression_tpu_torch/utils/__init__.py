"""Host-side utilities: shot-partitioned evaluation metrics, config, metrics
logging, checkpoints and meters."""

from imbalanced_regression_tpu_torch.utils.metrics import (  # noqa: F401
    DepthEvaluator,
    STSShotAverage,
    regression_metrics,
    shot_metrics,
)
from imbalanced_regression_tpu_torch.utils.meters import AverageMeter, ProgressMeter  # noqa: F401
