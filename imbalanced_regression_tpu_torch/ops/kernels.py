"""1-D kernel-window construction for LDS and FDS.

Two distinct normalizations exist in the reference and both are preserved here
(easy to conflate — see SURVEY.md §2 "per-suite deltas"):

- the **LDS** window is *max*-normalized (gaussian/laplace) or un-normalized
  (triang): reference ``imdb-wiki-dir/utils.py:110-122``.
- the **FDS** smoothing window is *sum*-normalized for all three kernel types:
  reference ``imdb-wiki-dir/fds.py:37-52``.

These run once on the host at setup time, so they are plain numpy; parity with
the reference is bit-comparable (same scipy calls, same dtypes — note the FDS
gaussian path builds its delta kernel in float32 while the LDS path uses the
float64 default).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.signal.windows import triang

VALID_KERNELS = ("gaussian", "triang", "laplace")


def _laplace_window(ks: int, sigma: float) -> np.ndarray:
    half_ks = (ks - 1) // 2
    x = np.arange(-half_ks, half_ks + 1)
    return np.exp(-np.abs(x) / sigma) / (2.0 * sigma)


def get_lds_kernel_window(kernel: str, ks: int, sigma: float) -> np.ndarray:
    """Label-distribution-smoothing window (max-normalized).

    Matches ``get_lds_kernel_window`` in the reference
    (``imdb-wiki-dir/utils.py:110-122``): the gaussian branch filters a length-
    ``ks`` discrete delta with scipy's reflect-boundary gaussian filter, then
    divides by the max; triang is the raw (peak-1) triangular window; laplace
    is the max-normalized discrete Laplace density.
    """
    if kernel not in VALID_KERNELS:
        raise ValueError(f"kernel must be one of {VALID_KERNELS}, got {kernel!r}")
    if ks % 2 != 1 or ks < 1:
        raise ValueError(f"kernel size must be a positive odd number, got {ks}")
    half_ks = (ks - 1) // 2
    if kernel == "gaussian":
        delta = np.array([0.0] * half_ks + [1.0] + [0.0] * half_ks)
        smoothed = gaussian_filter1d(delta, sigma=sigma)
        return smoothed / max(smoothed)
    if kernel == "triang":
        return triang(ks)
    lap = _laplace_window(ks, sigma)
    return lap / max(lap)


def get_fds_kernel_window(kernel: str, ks: int, sigma: float) -> np.ndarray:
    """Feature-distribution-smoothing window (sum-normalized).

    Matches ``FDS._get_kernel_window`` (``imdb-wiki-dir/fds.py:37-52``). The
    gaussian branch builds the delta in float32 (the reference constructs
    ``base_kernel`` as a float32 array), which makes the output float32.
    """
    if kernel not in VALID_KERNELS:
        raise ValueError(f"kernel must be one of {VALID_KERNELS}, got {kernel!r}")
    if ks % 2 != 1 or ks < 1:
        raise ValueError(f"kernel size must be a positive odd number, got {ks}")
    half_ks = (ks - 1) // 2
    if kernel == "gaussian":
        delta = np.array([0.0] * half_ks + [1.0] + [0.0] * half_ks, dtype=np.float32)
        smoothed = gaussian_filter1d(delta, sigma=sigma)
        return smoothed / sum(smoothed)
    if kernel == "triang":
        win = triang(ks)
        return win / sum(win)
    lap = _laplace_window(ks, sigma)
    return lap / sum(lap)
