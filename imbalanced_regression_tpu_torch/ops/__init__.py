"""Pure compute ops: kernel windows, LDS weighting, binning, moments,
calibration and weighted losses (plain PyTorch paths + CUDA kernels)."""
