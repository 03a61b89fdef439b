"""imbalanced_regression_tpu_torch — the PyTorch/CUDA port of
``imbalanced_regression_tpu`` for NVIDIA Hopper (H100).

Same layout and public names as the JAX package, which stays the reference
it is held against:

- ``ops``     kernel windows, LDS weights, binning, losses, bucket smoothing,
              calibration, segment moments, and the hand-written CUDA kernels
              (``ops/cuda_kernels.py``, sources in ``csrc/``).
- ``fds``     Feature Distribution Smoothing state and transitions.
- ``models``  the ResNet family (18/34/50/101/152, with remat) and the
              regression head; the NYUD2 depth encoder-decoder and head;
              the STS-B GloVe + BiLSTM pair encoder.
- ``data``    on-device augmentation, synthetic data, batching (nested
              batches, endless streams), the NYUD2 and STS-B pipelines.
- ``utils``   shot and depth metrics, config, metrics logging,
              checkpoints, meters.
- ``train``   the trainer: Adam or SGD, clipping, RRT, mid-epoch resume,
              indexed steps over device-resident data.
- ``tasks``   the age-regression, NYUD2 depth and STS-B drivers.
- ``parallel`` data parallelism over ``torch.distributed``: the mesh, the
              launch of local ranks, a dry run of every task family.
- ``serving`` frozen ``torch.export`` predictors: export, load, serve.
- ``tools``   the CLIs: export, serve-bench, bench, sweep, the dataset
              tools and the tutorial's notebook maker.
- ``entry``   the single-card flagship forward (``entry``) and the
              multi-rank dry run (``dryrun_multichip``).
- ``tutorial`` the DIR recipe on a custom dataset (LDS, FDS, shot metrics).

Entry points run on ``cuda`` unless the caller asks for ``cpu``.

The package exports the JAX package's names (the kernel windows, the five
weighted losses, ``calibrate_mean_var`` and the FDS state and transitions),
each imported from its module at first access, as is a submodule reached
as an attribute (``irt.ops``): ``import imbalanced_regression_tpu_torch``
alone imports no submodule, so a process that loads a frozen predictor
imports only ``serving``.
"""

import importlib
import importlib.util

__version__ = "0.1.0"

_EXPORTS = {
    "ops": ("get_lds_kernel_window", "get_fds_kernel_window", "weighted_mse_loss",
            "weighted_l1_loss", "weighted_focal_mse_loss", "weighted_focal_l1_loss",
            "weighted_huber_loss", "calibrate_mean_var"),
    "fds": ("FDSConfig", "FDSState", "fds_init", "fds_smooth", "fds_update_running_stats",
            "fds_update_last_epoch_stats", "fds_reset"),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name: str):
    """An exported name, or a submodule (``irt.ops``), imported at first
    access."""
    if name in _MODULE_OF:
        value = getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
    elif not name.startswith("_") and importlib.util.find_spec(f"{__name__}.{name}"):
        value = importlib.import_module(f"{__name__}.{name}")
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted({*globals(), *__all__})
