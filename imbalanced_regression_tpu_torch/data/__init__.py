"""Input pipelines: batching, synthetic data, on-device augmentation."""

from imbalanced_regression_tpu_torch.data.batching import batch_iterator, eval_batches  # noqa: F401
from imbalanced_regression_tpu_torch.data.synthetic import synthetic_age_dataset  # noqa: F401
