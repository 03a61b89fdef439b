"""FDS (Feature Distribution Smoothing) on PyTorch.

The reference implements FDS as a stateful ``nn.Module`` with registered
buffers and per-unique-label Python loops over GPU tensors
(``imdb-wiki-dir/fds.py:14-144``, ``sts-b-dir/fds.py``,
``nyud2-dir/models/fds.py``). Here, as in the JAX package, it is a state
record plus transition functions:

- :class:`FDSState` holds the running statistics as float32 tensors on the
  device, and the epoch counter on the host;
- every transition is built from dense segment moments and gathered
  calibration, with no per-label Python loop and no host sync on the train
  step;
- moments are additive across batches, so the epoch-end stats pass streams
  per-batch moments instead of gathering every encoding to the host.

Three grouping semantics are preserved exactly (SURVEY.md §2.3-2.5):

- ``"age"``: group by raw integer-valued label; edge buckets pool
  ``labels <= bucket_start`` / ``labels >= bucket_num - 1`` but only act when
  the exact edge label is present in the update/smooth batch
  (``imdb-wiki-dir/fds.py:91-99,120-143``).
- ``"hist"`` (STS-B): labels are pre-binned on the host with float64 histogram
  edges (see :func:`ops.binning.bin_index_hist_np`); empty buckets are imputed
  sequentially from neighbors after every update (``sts-b-dir/fds.py:112-125``).
- ``"depth"`` (NYUD2): dense per-pixel labels binned on the device by float32
  truncation ``clamp(trunc(10 * d), bucket_start, bucket_num - 1)``
  (``nyud2-dir/models/fds.py:51-53,138-139``).

On a CUDA tensor, calibration runs through the K1/K2 kernels
(:class:`ops.cuda_kernels.FDSCalibrate`) and the moments through K3.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from imbalanced_regression_tpu_torch.ops.cuda_kernels import FDSCalibrate
from imbalanced_regression_tpu_torch.ops.kernels import get_fds_kernel_window
from imbalanced_regression_tpu_torch.ops.moments import BucketMoments, bucket_moments, zero_moments
from imbalanced_regression_tpu_torch.ops.smoothing import smooth_bucket_stats

GROUPINGS = ("age", "hist", "depth")


@dataclasses.dataclass(frozen=True)
class FDSConfig:
    """Static FDS configuration (constructor parity with the reference
    ``FDS(feature_dim, bucket_num, bucket_start, start_update, start_smooth,
    kernel, ks, sigma, momentum)``; the extra fields capture what the
    reference hardcodes per suite)."""

    feature_dim: int
    bucket_num: int = 100
    bucket_start: int = 0
    start_update: int = 0
    start_smooth: int = 1
    kernel: str = "gaussian"
    ks: int = 5
    sigma: float = 2.0
    momentum: float | None = 0.9
    # per-suite deltas
    grouping: str = "age"  # 'age' | 'hist' | 'depth'
    clip_min: float = 0.1
    clip_max: float = 10.0
    guard_mode: str = "nonzero"  # 'nonzero' (age) | 'positive' (sts/nyud2)
    impute_empty: bool = False  # STS-B neighbor imputation of empty buckets

    def __post_init__(self):
        if self.grouping not in GROUPINGS:
            raise ValueError(f"grouping must be one of {GROUPINGS}, got {self.grouping!r}")

    @property
    def num_buckets(self) -> int:
        return self.bucket_num - self.bucket_start

    @functools.cached_property
    def window(self) -> np.ndarray:
        return np.asarray(get_fds_kernel_window(self.kernel, self.ks, self.sigma), np.float32)

    # ---- per-suite presets -------------------------------------------------
    @classmethod
    def for_age(cls, feature_dim: int = 2048, bucket_start: int = 0, **kw) -> "FDSConfig":
        """IMDB-WIKI (bucket_start=0) / AgeDB (bucket_start=3) preset."""
        return cls(feature_dim=feature_dim, bucket_num=kw.pop("bucket_num", 100),
                   bucket_start=bucket_start, grouping="age",
                   clip_min=0.1, clip_max=10.0, guard_mode="nonzero", **kw)

    @classmethod
    def for_sts(cls, feature_dim: int = 12000, **kw) -> "FDSConfig":
        return cls(feature_dim=feature_dim, bucket_num=kw.pop("bucket_num", 50),
                   grouping="hist", clip_min=0.5, clip_max=2.0,
                   guard_mode="positive", impute_empty=True, **kw)

    @classmethod
    def for_depth(cls, feature_dim: int = 128, **kw) -> "FDSConfig":
        return cls(feature_dim=feature_dim, bucket_num=kw.pop("bucket_num", 100),
                   bucket_start=kw.pop("bucket_start", 7), grouping="depth",
                   clip_min=0.2, clip_max=5.0, guard_mode="positive", **kw)


@dataclasses.dataclass
class FDSState:
    """Running FDS statistics — the reference's registered buffers
    (``imdb-wiki-dir/fds.py:28-35``). Transitions return a new state and
    never write into the tensors of the old one."""

    epoch: int  # starts at start_update; host-side, so epoch gates need no sync
    running_mean: torch.Tensor  # [B, D]
    running_var: torch.Tensor  # [B, D]
    running_mean_last_epoch: torch.Tensor  # [B, D]
    running_var_last_epoch: torch.Tensor  # [B, D]
    smoothed_mean_last_epoch: torch.Tensor  # [B, D]
    smoothed_var_last_epoch: torch.Tensor  # [B, D]
    num_samples_tracked: torch.Tensor  # [B]

    def replace(self, **changes) -> "FDSState":
        return dataclasses.replace(self, **changes)


def fds_init(config: FDSConfig, device="cuda") -> FDSState:
    b, d = config.num_buckets, config.feature_dim
    zeros = lambda: torch.zeros((b, d), dtype=torch.float32, device=device)  # noqa: E731
    ones = lambda: torch.ones((b, d), dtype=torch.float32, device=device)  # noqa: E731
    return FDSState(
        epoch=config.start_update,
        running_mean=zeros(),
        running_var=ones(),
        running_mean_last_epoch=zeros(),
        running_var_last_epoch=ones(),
        smoothed_mean_last_epoch=zeros(),
        smoothed_var_last_epoch=ones(),
        num_samples_tracked=torch.zeros((b,), dtype=torch.float32, device=device),
    )


def fds_reset(state: FDSState) -> FDSState:
    """Zero means / unit vars / zero counts, keeping the epoch counter
    (reference ``FDS.reset``, ``imdb-wiki-dir/fds.py:69-76``)."""
    return state.replace(
        running_mean=torch.zeros_like(state.running_mean),
        running_var=torch.ones_like(state.running_var),
        running_mean_last_epoch=torch.zeros_like(state.running_mean_last_epoch),
        running_var_last_epoch=torch.ones_like(state.running_var_last_epoch),
        smoothed_mean_last_epoch=torch.zeros_like(state.smoothed_mean_last_epoch),
        smoothed_var_last_epoch=torch.ones_like(state.smoothed_var_last_epoch),
        num_samples_tracked=torch.zeros_like(state.num_samples_tracked),
    )


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------


def _squeeze_labels(labels: torch.Tensor) -> torch.Tensor:
    if labels.ndim > 1 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    return labels.reshape(-1)


def _check_features(config: FDSConfig, features: torch.Tensor) -> torch.Tensor:
    """Flatten to [N, feature_dim], rejecting dimension mismatches up front
    (reference asserts the same, ``imdb-wiki-dir/fds.py:88``)."""
    if features.shape[-1] != config.feature_dim:
        raise ValueError(
            f"feature dimension {features.shape[-1]} does not match "
            f"FDSConfig.feature_dim={config.feature_dim} (features shape {tuple(features.shape)})"
        )
    return features.reshape(-1, config.feature_dim)


def _bucketize(config: FDSConfig, labels, bucket_idx):
    """Return (idx [N] int32 in [0, num_buckets), is_lo [N], is_hi [N],
    in_range [N]) for the configured grouping.

    ``is_lo/is_hi`` flag samples whose label is *exactly* the edge label
    (age grouping gate); ``in_range`` flags samples eligible without a gate
    (interior labels). For 'hist'/'depth' every sample is eligible.
    """
    if config.grouping == "hist":
        if bucket_idx is None:
            raise ValueError(
                "grouping='hist' needs host-precomputed bucket_idx "
                "(ops.binning.bin_index_hist_np) for exact histogram-edge parity"
            )
        idx = bucket_idx.to(torch.int32).reshape(-1) - config.bucket_start
        true = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        return idx, true, true, true

    labels = _squeeze_labels(labels).to(torch.float32)
    if config.grouping == "depth":
        scaled = (labels * 10.0).to(torch.int32)
        idx = scaled.clamp(config.bucket_start, config.bucket_num - 1) - config.bucket_start
        true = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        return idx, true, true, true

    # 'age': group by raw integer-valued label with edge pooling
    lo = float(config.bucket_start)
    hi = float(config.bucket_num - 1)
    trunc = labels.to(torch.int32)  # labels >= 0 → trunc == floor
    idx = (trunc - config.bucket_start).clamp(0, config.num_buckets - 1)
    is_lo = labels == lo
    is_hi = labels == hi
    in_range = (labels > lo) & (labels < hi)
    return idx, is_lo, is_hi, in_range


def _sample_ok(config: FDSConfig, labels, is_lo, is_hi, in_range):
    """Per-sample eligibility for smoothing/stats membership.

    For the age grouping, pooled out-of-range samples only participate when
    the exact edge label appears in the batch (torch.unique gating,
    ``imdb-wiki-dir/fds.py:120-136``)."""
    if config.grouping != "age":
        return torch.ones(is_lo.shape, dtype=torch.bool, device=is_lo.device)
    labels = _squeeze_labels(labels).to(torch.float32)
    lo = float(config.bucket_start)
    hi = float(config.bucket_num - 1)
    return in_range | ((labels <= lo) & is_lo.any()) | ((labels >= hi) & is_hi.any())


# ---------------------------------------------------------------------------
# running-stats update
# ---------------------------------------------------------------------------


def fds_bucket_moments(config: FDSConfig, features, labels, bucket_idx=None) -> BucketMoments:
    """Per-bucket moments of one batch; additive across batches/shards."""
    features = _check_features(config, features)
    idx, is_lo, is_hi, _ = _bucketize(config, labels, bucket_idx)
    edge = (is_lo, is_hi) if config.grouping == "age" else None
    return bucket_moments(features, idx, config.num_buckets, edge_labels=edge)


def fds_apply_moments(config: FDSConfig, state: FDSState, moments: BucketMoments,
                      epoch: int) -> FDSState:
    """EMA-update running stats from aggregated moments.

    Matches ``FDS.update_running_stats`` (``imdb-wiki-dir/fds.py:84-113``):
    per-bucket count accumulation, momentum (or count-weighted) factor,
    ``factor = 0`` on the ``start_update`` epoch, edge-bucket gating for the
    age grouping, and — for STS — sequential neighbor imputation of buckets
    empty in this update (``sts-b-dir/fds.py:112-125``). The whole update is
    skipped when ``epoch < state.epoch``.
    """
    if epoch < state.epoch:
        return state
    count = moments.count  # [B]
    gate = count > 0
    if config.grouping == "age":
        gate = gate.clone()
        gate[0] &= moments.has_lo
        gate[-1] &= moments.has_hi

    mean_b, var_b = moments.mean_var()
    new_tracked = state.num_samples_tracked + torch.where(gate, count, torch.zeros_like(count))

    if epoch == config.start_update:
        factor = torch.zeros_like(count)
    elif config.momentum is not None:
        factor = torch.full_like(count, config.momentum)
    else:
        factor = 1.0 - count / torch.clamp(new_tracked, min=1.0)

    f = factor[:, None]
    gate_col = gate[:, None]
    new_mean = torch.where(gate_col, (1.0 - f) * mean_b + f * state.running_mean, state.running_mean)
    new_var = torch.where(gate_col, (1.0 - f) * var_b + f * state.running_var, state.running_var)

    if config.impute_empty:
        new_mean, new_var = _impute_empty_buckets(new_mean, new_var, count)

    return state.replace(running_mean=new_mean, running_var=new_var,
                         num_samples_tracked=new_tracked)


def _impute_empty_buckets(mean, var, count):
    """Sequential neighbor copy/average for buckets with zero samples in this
    update. Ascending order matters: an interior bucket's left neighbor may
    itself have just been imputed (``sts-b-dir/fds.py:112-125``). Runs once
    per epoch; the one host read of the counts picks the empty buckets."""
    b = mean.shape[0]
    mean, var = mean.clone(), var.clone()
    empty = (count == 0).tolist()
    for j in range(b):
        if not empty[j]:
            continue
        # first bucket copies its right neighbor; last copies left; interior
        # averages both (current, possibly already-imputed values)
        left, right = max(j - 1, 0), min(j + 1, b - 1)
        if j == 0:
            mean[j], var[j] = mean[right], var[right]
        elif j == b - 1:
            mean[j], var[j] = mean[left], var[left]
        else:
            mean[j] = (mean[left] + mean[right]) / 2.0
            var[j] = (var[left] + var[right]) / 2.0
    return mean, var


def fds_update_running_stats(config: FDSConfig, state: FDSState, features, labels, epoch: int,
                             bucket_idx=None) -> FDSState:
    """One-call API parity with the reference ``FDS.update_running_stats``."""
    return fds_apply_moments(config, state, fds_bucket_moments(config, features, labels, bucket_idx),
                             epoch)


def fds_update_last_epoch_stats(config: FDSConfig, state: FDSState, epoch: int) -> FDSState:
    """Snapshot running stats and kernel-smooth them along the bucket axis.

    Only acts when ``epoch == state.epoch + 1``, incrementing the internal
    epoch counter (``imdb-wiki-dir/fds.py:78-82``)."""
    if epoch != state.epoch + 1:
        return state
    return state.replace(
        epoch=state.epoch + 1,
        running_mean_last_epoch=state.running_mean,
        running_var_last_epoch=state.running_var,
        smoothed_mean_last_epoch=smooth_bucket_stats(state.running_mean, config.window),
        smoothed_var_last_epoch=smooth_bucket_stats(state.running_var, config.window),
    )


# ---------------------------------------------------------------------------
# smoothing (per-sample feature calibration)
# ---------------------------------------------------------------------------


def fds_smooth(config: FDSConfig, state: FDSState, features, labels, epoch: int, bucket_idx=None):
    """Calibrate features toward the smoothed bucket statistics.

    Functional equivalent of ``FDS.smooth`` (``imdb-wiki-dir/fds.py:115-144``):
    gather each sample's bucket rows from the last-epoch running and smoothed
    stats and apply the calibrate transform. Identity while
    ``epoch < start_smooth``. Accepts [N, D] features (flatten dense maps
    before calling). The gather and calibrate run as one kernel (K1, with K2
    as its backward) on a CUDA tensor, and as its plain version on the CPU.
    """
    # The JAX step computes the calibration and then discards it before
    # start_smooth (it is traced once for every epoch); eager PyTorch skips
    # the launch instead.
    if epoch < config.start_smooth:
        return features
    x = _check_features(config, features)
    idx, is_lo, is_hi, in_range = _bucketize(config, labels, bucket_idx)
    ok = _sample_ok(config, labels, is_lo, is_hi, in_range)
    v1sum = state.running_var_last_epoch.sum(dim=1)
    calibrated = FDSCalibrate.apply(
        x.contiguous(), idx.contiguous(), ok.contiguous(),
        state.running_mean_last_epoch, state.running_var_last_epoch,
        state.smoothed_mean_last_epoch, state.smoothed_var_last_epoch, v1sum,
        config.clip_min, config.clip_max, config.guard_mode,
    )
    return calibrated.reshape(features.shape).to(features.dtype)


def fds_zero_moments(config: FDSConfig, device="cuda") -> BucketMoments:
    """Identity moments for streaming accumulation over an epoch pass."""
    return zero_moments(config.num_buckets, config.feature_dim, device=device)

