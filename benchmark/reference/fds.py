"""LDS and FDS as the DIR reference code defines them (Yang et al., ICML
2021): ``imdb-wiki-dir/fds.py``, ``imdb-wiki-dir/utils.py``,
``imdb-wiki-dir/datasets.py`` for ages, ``sts-b-dir/fds.py``,
``sts-b-dir/util.py``, ``sts-b-dir/tasks.py`` for STS-B scores.

Statistics are gathered over a whole pass and computed per bucket in
float64 (two passes over the rows), stored in float32; the smoothing is the
reference's reflect-padded ``conv1d``; the calibration gathers each row's
bucket and applies ``(x - m1) * sqrt(clip(v2 / v1)) + m2`` where the guards
allow, so autograd gives its gradient in ``x``."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import convolve1d, gaussian_filter1d


def _delta(ks: int, dtype) -> np.ndarray:
    half = (ks - 1) // 2
    return np.array([0.0] * half + [1.0] + [0.0] * half, dtype=dtype)


def lds_window(ks: int, sigma: float) -> np.ndarray:
    """The gaussian LDS window, divided by its largest value."""
    w = gaussian_filter1d(_delta(ks, np.float64), sigma=sigma)
    return w / max(w)


def fds_window(ks: int, sigma: float) -> torch.Tensor:
    """The gaussian FDS window (built in float32), divided by its sum."""
    w = gaussian_filter1d(_delta(ks, np.float32), sigma=sigma)
    return torch.tensor(w / sum(w), dtype=torch.float32)


def hist_edges(bucket_num: int) -> np.ndarray:
    """STS-B's bin edges over [0, 5]: ``np.histogram`` of an empty float32
    array (float32 edges)."""
    return np.histogram(np.array([], dtype=np.float32), bins=bucket_num, range=(0.0, 5.0))[1]


def hist_bins(scores, bucket_num: int) -> np.ndarray:
    """STS-B's bucket of each score: the first edge above it, minus one; a
    score of 5 is the last bucket."""
    scores = np.asarray(scores, dtype=np.float32).reshape(-1)
    edges = hist_edges(bucket_num)
    first_above = np.argmax(edges[None, :] > scores[:, None], axis=1)
    return np.where(scores == np.float32(5.0), bucket_num - 1, first_above - 1).astype(np.int64)


def _scaled_inverse(per_label) -> np.ndarray:
    weights = np.asarray([np.float32(1.0 / x) for x in per_label], dtype=np.float32)
    return (len(weights) / np.sum(weights) * weights).astype(np.float32)


def lds_weights_age(labels, reweight: str, ks: int, sigma: float, max_target: int = 121):
    """Per-sample LDS weights of integer ages (``_prepare_weights``)."""
    bins = np.minimum(np.asarray(labels).reshape(-1).astype(int), max_target - 1)
    counts = np.bincount(bins, minlength=max_target)
    value = np.sqrt(counts) if reweight == "sqrt_inv" else np.clip(counts, 5, 1000)
    smoothed = convolve1d(value, weights=lds_window(ks, sigma), mode="constant")
    return _scaled_inverse(smoothed[bins])


def lds_weights_hist(scores, reweight: str, ks: int, sigma: float, bucket_num: int):
    """Per-sample LDS weights of STS-B scores (``tasks.py``): the histogram
    over [0, 5], the square root for ``sqrt_inv``, the window convolved in
    the histogram's own type (integer counts stay integer)."""
    scores = np.asarray(scores, dtype=np.float32).reshape(-1)
    counts, _ = np.histogram(scores, bins=bucket_num, range=(0.0, 5.0))
    if reweight == "sqrt_inv":
        counts = np.sqrt(counts)
    smoothed = convolve1d(counts, weights=lds_window(ks, sigma), mode="constant")
    return _scaled_inverse(smoothed[hist_bins(scores, bucket_num)])


@dataclasses.dataclass
class FDSConfig:
    feature_dim: int
    bucket_num: int
    bucket_start: int
    start_update: int
    start_smooth: int
    ks: int
    sigma: float
    momentum: float
    grouping: str  # "age": integer labels with pooled edges; "hist": bucket indices
    clip_min: float
    clip_max: float
    guard: str  # "nonzero" (ages) or "positive" (STS-B)


class FDS:
    """The reference module's buffers and its three methods."""

    def __init__(self, cfg: FDSConfig, device):
        self.cfg, self.epoch = cfg, cfg.start_update
        b, d = cfg.bucket_num - cfg.bucket_start, cfg.feature_dim
        z = lambda: torch.zeros(b, d, device=device)  # noqa: E731
        o = lambda: torch.ones(b, d, device=device)  # noqa: E731
        self.running_mean, self.running_var = z(), o()
        self.mean_last, self.var_last = z(), o()
        self.smoothed_mean, self.smoothed_var = z(), o()
        self.tracked = torch.zeros(b, device=device, dtype=torch.float64)
        self.window = fds_window(cfg.ks, cfg.sigma).to(device)

    def _smooth(self, t: torch.Tensor) -> torch.Tensor:
        half = (self.cfg.ks - 1) // 2
        x = F.pad(t.unsqueeze(1).permute(2, 1, 0), pad=(half, half), mode="reflect")
        return F.conv1d(x, self.window.view(1, 1, -1)).permute(2, 1, 0).squeeze(1)

    def update_last_epoch_stats(self, epoch: int) -> None:
        if epoch == self.epoch + 1:
            self.epoch += 1
            self.mean_last, self.var_last = self.running_mean, self.running_var
            self.smoothed_mean = self._smooth(self.mean_last)
            self.smoothed_var = self._smooth(self.var_last)

    def _groups(self, labels: torch.Tensor):
        """(bucket, rows) for each bucket the pass updates."""
        c = self.cfg
        if c.grouping == "hist":
            for b in torch.unique(labels).tolist():
                yield b - c.bucket_start, labels == b
            return
        lo, hi = c.bucket_start, c.bucket_num - 1
        for label in torch.unique(labels).tolist():
            if label > hi or label < lo:
                continue
            rows = labels <= label if label == lo else (labels >= label if label == hi
                                                          else labels == label)
            yield int(label - lo), rows

    @torch.no_grad()
    def update_running_stats(self, features: torch.Tensor, labels: torch.Tensor,
                             epoch: int) -> None:
        """``labels``: integer ages ("age") or bucket indices ("hist")."""
        if epoch < self.epoch:
            return
        c = self.cfg
        mean, var = self.running_mean.clone(), self.running_var.clone()
        updated = set()
        for b, rows in self._groups(labels):
            f = features[rows].double()
            n = f.shape[0]
            m = f.mean(0)
            v = ((f - m) ** 2).sum(0) / (n - 1 if n > 1 else 1)
            self.tracked[b] += n
            factor = 0.0 if epoch == c.start_update else c.momentum
            mean[b] = ((1 - factor) * m + factor * mean[b].double()).float()
            var[b] = ((1 - factor) * v + factor * var[b].double()).float()
            updated.add(b)
        if c.grouping == "hist":  # buckets with no sample copy or average their neighbours
            last = mean.shape[0] - 1
            for b in range(last + 1):
                if b in updated:
                    continue
                if b == 0:
                    mean[0], var[0] = mean[1], var[1]
                elif b == last:
                    mean[b], var[b] = mean[b - 1], var[b - 1]
                else:
                    mean[b] = (mean[b - 1] + mean[b + 1]) / 2.0
                    var[b] = (var[b - 1] + var[b + 1]) / 2.0
        self.running_mean, self.running_var = mean, var

    def smooth(self, features: torch.Tensor, labels: torch.Tensor, epoch: int) -> torch.Tensor:
        """Calibrate each row toward its bucket's smoothed statistics."""
        c = self.cfg
        if epoch < c.start_smooth:
            return features
        if c.grouping == "hist":
            bucket = labels - c.bucket_start
            ok = torch.ones_like(bucket, dtype=torch.bool)
        else:
            lo, hi = float(c.bucket_start), float(c.bucket_num - 1)
            bucket = (labels.clamp(lo, hi) - lo).long()
            ok = ((labels > lo) & (labels < hi)) | ((labels <= lo) & (labels == lo).any()) \
                | ((labels >= hi) & (labels == hi).any())
        m1, v1 = self.mean_last[bucket], self.var_last[bucket]
        m2, v2 = self.smoothed_mean[bucket], self.smoothed_var[bucket]
        if c.guard == "nonzero":
            col = v1 != 0.0
        else:
            col = (v1 > 0.0) & (v2 >= 0.0)
        factor = torch.clamp(v2 / torch.where(col, v1, torch.ones_like(v1)), c.clip_min, c.clip_max)
        row = (v1.sum(1) >= 1e-10) & ok
        out = (features - m1) * torch.sqrt(factor) + m2
        return torch.where(col & row[:, None], out, features)
