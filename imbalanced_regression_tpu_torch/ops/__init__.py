"""Pure compute ops: kernel windows, LDS weighting, binning, moments,
calibration and weighted losses (plain PyTorch paths + CUDA kernels).

Exports the JAX ``ops`` package's names (``imbalanced_regression_tpu/ops/
__init__.py``); importing it builds no kernel (``cuda_kernels`` builds at
a wrapper's first launch)."""

from imbalanced_regression_tpu_torch.ops.kernels import (  # noqa: F401
    get_lds_kernel_window,
    get_fds_kernel_window,
)
from imbalanced_regression_tpu_torch.ops.losses import (  # noqa: F401
    weighted_mse_loss,
    weighted_l1_loss,
    weighted_focal_mse_loss,
    weighted_focal_l1_loss,
    weighted_huber_loss,
)
from imbalanced_regression_tpu_torch.ops.calibrate import calibrate_mean_var  # noqa: F401
from imbalanced_regression_tpu_torch.ops.binning import (  # noqa: F401
    bin_index_hist_np,
    hist_bin_edges,
    bin_index_depth,
    bin_index_age,
)
from imbalanced_regression_tpu_torch.ops.lds import (  # noqa: F401
    prepare_weights_age,
    prepare_weights_hist,
    prepare_weights_depth,
)
from imbalanced_regression_tpu_torch.ops.smoothing import smooth_bucket_stats  # noqa: F401
from imbalanced_regression_tpu_torch.ops.moments import BucketMoments, bucket_moments  # noqa: F401
