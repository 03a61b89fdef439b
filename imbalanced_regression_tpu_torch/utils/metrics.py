"""Shot-partitioned evaluation metrics for all three task families.

Host-side numpy (evaluation happens once per epoch on gathered predictions;
scipy's gmean/pearsonr/spearmanr are the reference's own scorers):

- :func:`shot_metrics` — age suites: regions are defined by *training* label
  frequency (many > 100, low < 20 samples; ``imdb-wiki-dir/train.py:338-391``).
- :class:`STSShotAverage` — STS-B: hardcoded 50-bin index sets, predictions
  rescaled x5 (``sts-b-dir/util.py:101-171``).
- :class:`DepthEvaluator` — NYUD2: RMSE/ABS_REL/LG10/MAE/deltas with NaN
  masking and hardcoded 100-bin shot sets (``nyud2-dir/util.py:35-133``).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
from scipy.stats import gmean, pearsonr, spearmanr

from imbalanced_regression_tpu_torch.ops.binning import bin_index_depth, bin_index_hist_np


def regression_metrics(preds, labels) -> dict:
    """Overall MSE / L1 / G-mean of L1 errors (the reference's validate())."""
    preds = np.asarray(preds, dtype=np.float64).reshape(-1)
    labels = np.asarray(labels, dtype=np.float64).reshape(-1)
    err = np.abs(preds - labels)
    return {
        "mse": float(np.mean(err**2)),
        "l1": float(np.mean(err)),
        "gmean": float(gmean(err, axis=None)) if err.size else 0.0,
    }


def shot_metrics(preds, labels, train_labels, many_shot_thr: int = 100, low_shot_thr: int = 20) -> dict:
    """Region-partitioned MSE/L1/G-mean for integer-labeled tasks.

    Matches the reference ``shot_metrics`` (``imdb-wiki-dir/train.py:338-391``):
    per-unique-*test*-label sums are routed to many/median/low regions by the
    *training* count of that label, then normalized by test counts.
    """
    preds = np.asarray(preds).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    train_labels = np.asarray(train_labels).astype(int)

    region_sums = {r: {"mse": 0.0, "l1": 0.0, "cnt": 0} for r in ("many", "median", "low")}
    region_errs = {r: [] for r in ("many", "median", "low")}
    for l in np.unique(labels):
        mask = labels == l
        train_count = int(np.sum(train_labels == l))
        err = np.abs(preds[mask] - labels[mask])
        if train_count > many_shot_thr:
            region = "many"
        elif train_count < low_shot_thr:
            region = "low"
        else:
            region = "median"
        region_sums[region]["mse"] += float(np.sum(err**2))
        region_sums[region]["l1"] += float(np.sum(err))
        region_sums[region]["cnt"] += int(mask.sum())
        region_errs[region].append(err)

    shot_dict = defaultdict(dict)
    for region in ("many", "median", "low"):
        cnt = region_sums[region]["cnt"]
        shot_dict[region]["mse"] = region_sums[region]["mse"] / cnt if cnt else float("nan")
        shot_dict[region]["l1"] = region_sums[region]["l1"] / cnt if cnt else float("nan")
        errs = np.hstack(region_errs[region]) if region_errs[region] else np.array([])
        shot_dict[region]["gmean"] = float(gmean(errs, axis=None)) if errs.size else float("nan")
    return dict(shot_dict)


class STSShotAverage:
    """Accumulate-then-score STS-B metrics with hardcoded bin→region sets
    (``sts-b-dir/util.py:109-113``). Predictions are model outputs in [0, 1]
    scale and get multiplied by 5 for scoring (``util.py:143``)."""

    SHOT_IDX = {
        "many": [0, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 49],
        "medium": [2, 4, 6, 8, 27, 35, 37],
        "few": [1, 3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 29, 31, 33, 39, 41, 43, 45, 47],
    }

    def __init__(self, metric=("mse", "l1", "gmean", "pearsonr", "spearmanr"), num_bins: int = 50):
        self._metric = tuple(metric)
        self._num_bins = num_bins
        self.reset()

    def reset(self):
        self._pred: list = []
        self._label: list = []
        self._count = 0

    def __call__(self, pred, label):
        self._pred += np.asarray(pred).reshape(-1).tolist()
        self._label += np.asarray(label).reshape(-1).tolist()
        self._count += len(np.asarray(pred).reshape(-1))

    def _bin2shot(self, idx: int) -> str:
        if idx in self.SHOT_IDX["many"]:
            return "many"
        if idx in self.SHOT_IDX["medium"]:
            return "medium"
        return "few"

    def get_metric(self, reset: bool = False, type: str | None = None) -> dict:
        labels = np.array(self._label)
        preds = np.array(self._pred)
        bins = bin_index_hist_np(labels, self._num_bins) if labels.size else np.array([], int)
        category = np.array([self._bin2shot(int(b)) for b in bins])

        metric = {s: {} for s in ("many", "medium", "few", "overall")}
        for shot in ("overall", "many", "medium", "few"):
            if shot == "overall":
                p, l = preds * 5.0, labels
            else:
                sel = category == shot
                p, l = preds[sel] * 5.0, labels[sel]
            if "mse" in self._metric:
                metric[shot]["mse"] = float(np.mean((p - l) ** 2)) if p.size else 0.0
            if "l1" in self._metric:
                metric[shot]["l1"] = float(np.mean(np.abs(p - l))) if p.size else 0.0
            if "gmean" in self._metric:
                if p.size:
                    diff = np.abs(p - l)
                    diff[diff == 0.0] += 1e-10  # zero-error guard (util.py:154-156)
                    metric[shot]["gmean"] = float(gmean(diff))
                else:
                    metric[shot]["gmean"] = 0.0
            if "pearsonr" in self._metric:
                metric[shot]["pearsonr"] = float(pearsonr(p, l)[0]) if p.size > 1 else 0.0
            if "spearmanr" in self._metric:
                metric[shot]["spearmanr"] = float(spearmanr(p, l)[0]) if p.size > 1 else 0.0
            metric[shot]["num_samples"] = int(p.size)
        if reset:
            self.reset()
        return metric["overall"] if type == "overall" else metric


class DepthEvaluator:
    """Streaming NYUD2 depth metrics with NaN masking and shot partitioning
    (``nyud2-dir/util.py:35-133``). Call with flattened (or any-shape) output/
    target arrays per batch; ``evaluate_shot()`` scores the accumulation."""

    SHOT_IDX = {
        "many": [9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 47, 49],
        "medium": [7, 8, 46, 48, 50, 51, 52, 53, 54, 55, 56, 58, 60, 61, 63],
        "few": [0, 1, 2, 3, 4, 5, 6, 57, 59, 62, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75,
                76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95,
                96, 97, 98, 99],
    }

    def __init__(self):
        self.reset()

    def reset(self):
        self._output: list = []
        self._depth: list = []

    def __call__(self, output, depth):
        self._output.append(np.asarray(output, dtype=np.float32).reshape(-1))
        self._depth.append(np.asarray(depth, dtype=np.float32).reshape(-1))

    @staticmethod
    def evaluate(output, depth) -> dict:
        output = np.asarray(output, dtype=np.float64).reshape(-1)
        depth = np.asarray(depth, dtype=np.float64).reshape(-1)
        errors = {k: 0.0 for k in ("MSE", "RMSE", "ABS_REL", "LG10", "MAE",
                                   "DELTA1", "DELTA2", "DELTA3")}
        errors["NUM"] = 0
        nan_mask = np.isnan(depth)
        n_valid = float(np.sum(~nan_mask))
        if n_valid > 0:
            out = np.where(nan_mask, 0.0, output)
            dep = np.where(nan_mask, 0.0, depth)
            diff = np.abs(out - dep)
            errors["MSE"] = float(np.sum(diff**2) / n_valid)
            errors["MAE"] = float(np.sum(diff) / n_valid)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.where(nan_mask, 0.0, diff / dep)
                lg10 = np.where(nan_mask, 0.0, np.abs(np.log10(out) - np.log10(dep)))
                max_ratio = np.maximum(out / dep, dep / out)
            errors["ABS_REL"] = float(np.sum(rel) / n_valid)
            errors["LG10"] = float(np.sum(lg10) / n_valid)
            for i, name in enumerate(("DELTA1", "DELTA2", "DELTA3"), start=1):
                errors[name] = float(np.sum(max_ratio <= 1.25**i) / n_valid)
            errors["NUM"] = int(n_valid)
        errors["RMSE"] = float(np.sqrt(errors["MSE"]))
        return errors

    def evaluate_shot(self) -> dict:
        output = np.concatenate(self._output) if self._output else np.array([])
        depth = np.concatenate(self._depth) if self._depth else np.array([])
        # NaN depths are excluded from every metric inside evaluate(); route
        # them to bin 0 so the shot binning itself stays defined
        buckets = bin_index_depth(np.nan_to_num(depth), 100, 0)
        metric = {"overall": self.evaluate(output, depth)}
        for shot, idxs in self.SHOT_IDX.items():
            mask = np.isin(buckets, idxs)
            metric[shot] = self.evaluate(output[mask], depth[mask])
        return metric
