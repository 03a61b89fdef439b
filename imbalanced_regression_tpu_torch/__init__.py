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
- ``tools``   the export and serve-bench CLIs.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""

__version__ = "0.1.0"
