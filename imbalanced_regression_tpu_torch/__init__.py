"""imbalanced_regression_tpu_torch — the PyTorch/CUDA port of
``imbalanced_regression_tpu`` for NVIDIA Hopper (H100).

Same layout and public names as the JAX package, which stays the reference
it is held against:

- ``ops``     kernel windows, LDS weights, binning, losses, bucket smoothing,
              calibration, segment moments, and the hand-written CUDA kernels
              (``ops/cuda_kernels.py``, sources in ``csrc/``).
- ``fds``     Feature Distribution Smoothing state and transitions.
- ``models``  ResNet-50 backbone and regression head.
- ``data``    on-device augmentation, synthetic data, batching.
- ``utils``   shot metrics, config, metrics logging.
- ``tasks``   the age-regression driver.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""

__version__ = "0.1.0"
