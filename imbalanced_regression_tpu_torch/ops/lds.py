"""LDS (Label Distribution Smoothing) effective-density sample weights.

Host-side, run once per dataset at pipeline construction. The empirical label
histogram is (optionally) transformed by sqrt / clipped-inverse re-weighting,
convolved with the LDS kernel window to produce an *effective* label density,
inverted into per-sample weights and rescaled to mean 1.

Three variants with per-suite deltas preserved exactly:
- age   (``imdb-wiki-dir/datasets.py:55-83``): integer bins, conv mode
        'constant', INV counts clipped to [5, 1000], mean-1 rescale.
- hist  (``sts-b-dir/tasks.py:44-73``): ``np.histogram`` bins over [0, 5],
        conv mode 'constant', mean-1 rescale.
- depth (``nyud2-dir/loaddata.py:29-53``): precomputed global per-bucket pixel
        counts, conv mode 'reflect' over buckets >= bucket_start with the
        smoothed value of the first kept bucket back-filled below it, and a
        rescale that keeps the *weighted pixel count* equal to the raw total.

The convolutions are tiny (<=121 bins) and run on the host via scipy for
bit-parity with the reference.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve1d

from imbalanced_regression_tpu_torch.ops.binning import bin_index_hist_np
from imbalanced_regression_tpu_torch.ops.kernels import get_lds_kernel_window

VALID_REWEIGHT = ("none", "inverse", "sqrt_inv")


def _check_reweight(reweight: str, lds: bool) -> None:
    if reweight not in VALID_REWEIGHT:
        raise ValueError(f"reweight must be one of {VALID_REWEIGHT}, got {reweight!r}")
    if lds and reweight == "none":
        raise ValueError("Set reweight to 'sqrt_inv' or 'inverse' when using LDS")


def prepare_weights_age(
    labels,
    reweight: str,
    max_target: int = 121,
    lds: bool = False,
    lds_kernel: str = "gaussian",
    lds_ks: int = 5,
    lds_sigma: float = 2.0,
) -> np.ndarray | None:
    """Per-sample weights for integer-binned targets (ages).

    Mirrors ``IMDBWIKI._prepare_weights`` (``imdb-wiki-dir/datasets.py:55-83``):
    count per integer label in [0, max_target), sqrt or clip-to-[5,1000]
    transform, optional constant-mode LDS convolution, inverse, mean-1 rescale.
    Returns None when ``reweight == 'none'`` (uniform weighting).
    """
    _check_reweight(reweight, lds)
    labels = np.asarray(labels)
    if reweight == "none" or labels.size == 0:
        return None

    bins = np.minimum(labels.astype(int), max_target - 1)
    counts = np.bincount(bins, minlength=max_target)  # int64
    if reweight == "sqrt_inv":
        counts = np.sqrt(counts)
    else:  # 'inverse': clip raw counts so rare labels don't explode
        counts = np.clip(counts, 5, 1000)

    if lds:
        window = get_lds_kernel_window(lds_kernel, lds_ks, lds_sigma)
        # NOTE: scipy preserves the input dtype, so for 'inverse' (integer
        # counts) the smoothed density is integer-truncated — the reference
        # convolves the raw clipped counts the same way (datasets.py:76-77).
        counts = convolve1d(counts, weights=window, mode="constant")

    per_sample = counts[bins]
    weights = (1.0 / per_sample).astype(np.float32)
    scaling = len(weights) / np.sum(weights)
    return (scaling * weights).astype(np.float32)


def prepare_weights_hist(
    targets,
    reweight: str,
    bucket_num: int = 50,
    value_range: tuple[float, float] = (0.0, 5.0),
    lds: bool = False,
    lds_kernel: str = "gaussian",
    lds_ks: int = 5,
    lds_sigma: float = 2.0,
) -> np.ndarray | None:
    """Per-sample weights for histogram-binned continuous targets (STS-B).

    Mirrors the LDS branch of ``load_tsv`` (``sts-b-dir/tasks.py:44-73``): the
    sqrt transform is applied to the raw histogram *before* the LDS
    convolution; 'inverse' applies no transform (the reference has no clip on
    this path).
    """
    _check_reweight(reweight, lds)
    targets = np.asarray(targets, dtype=np.float32)
    if reweight == "none" or targets.size == 0:
        return None

    counts, _ = np.histogram(targets, bins=bucket_num, range=value_range)  # int64
    if reweight == "sqrt_inv":
        counts = np.sqrt(counts)

    bins = bin_index_hist_np(targets, bucket_num, bucket_start=0, value_range=value_range)
    if lds:
        window = get_lds_kernel_window(lds_kernel, lds_ks, lds_sigma)
        # dtype-preserving conv: integer-truncated for 'inverse', like the
        # reference (tasks.py:66 convolves the raw histogram counts).
        counts = convolve1d(counts, weights=window, mode="constant")

    per_sample = counts[bins]
    weights = (1.0 / per_sample).astype(np.float32)
    scaling = len(weights) / np.sum(weights)
    return (scaling * weights).astype(np.float32)


def prepare_weights_depth(
    bucket_counts,
    reweight: str,
    bucket_num: int = 100,
    bucket_start: int = 7,
    lds: bool = False,
    lds_kernel: str = "gaussian",
    lds_ks: int = 5,
    lds_sigma: float = 2.0,
) -> np.ndarray | None:
    """Per-*bucket* weights for dense per-pixel targets (NYUD2 depth).

    Mirrors ``depthDataset._get_bucket_weights`` (``nyud2-dir/loaddata.py:29-53``):
    operates on a precomputed global pixel histogram. With LDS the counts from
    ``bucket_start`` on are sqrt-transformed, reflect-convolved, and the first
    smoothed value is back-filled below ``bucket_start``; without LDS the raw
    count of ``bucket_start`` is back-filled before the sqrt. The scaling makes
    the weighted total pixel count equal the raw total:
    ``scaling = sum(counts) / sum(counts / value)``.
    Per-pixel weights are then ``weights[bin_index_depth(depth)]``.
    """
    _check_reweight(reweight, lds)
    if reweight == "none":
        return None
    bucket_counts = np.asarray(bucket_counts)  # keep int dtype like the reference list
    if bucket_counts.shape[0] != bucket_num:
        raise ValueError(f"expected {bucket_num} bucket counts, got {bucket_counts.shape[0]}")

    if lds:
        value = bucket_counts[bucket_start:]
        if reweight == "sqrt_inv":
            value = np.sqrt(value)
        window = get_lds_kernel_window(lds_kernel, lds_ks, lds_sigma)
        # dtype-preserving conv (integer-truncated for 'inverse'), reflect mode
        smoothed = convolve1d(value, weights=window, mode="reflect")
        value = np.concatenate([np.full(bucket_start, smoothed[0], dtype=smoothed.dtype), smoothed])
    else:
        value = np.concatenate(
            [np.full(bucket_start, bucket_counts[bucket_start], dtype=bucket_counts.dtype),
             bucket_counts[bucket_start:]]
        )
        if reweight == "sqrt_inv":
            value = np.sqrt(value)

    scaling = np.sum(bucket_counts) / np.sum(bucket_counts / value)
    return (scaling / value).astype(np.float32)
