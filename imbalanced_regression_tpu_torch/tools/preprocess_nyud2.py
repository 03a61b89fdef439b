"""NYUD2-DIR preprocessing: the FDS training subset and the balanced
per-pixel test mask.

The counterpart of the JAX package's ``tools/preprocess_nyud2.py``
(``nyud2-dir/preprocess_nyud2.py:34-73``), with no pandas, through the
port's ``data/nyud2.py`` and ``ops/binning.py``:

- FDS subset: ``--subset_size`` (600) training images drawn uniformly at
  random (``np.random.choice`` after ``np.random.seed(--seed)``); their
  CSV rows become ``nyu2_train_FDS_subset.csv``, their indices
  ``FDS_train_subset_id.npy``;
- balanced test mask: every test-depth pixel in 100 bins over [0, 10] m;
  the smallest non-empty bin count of pixels is drawn from every bin from 7
  on, and the mask of the drawn pixels is ``test_balanced_mask.npy``.

Usage: ``python -m imbalanced_regression_tpu_torch.tools.preprocess_nyud2
--data_dir ./data [--seed 0]``
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from imbalanced_regression_tpu_torch.data.nyud2 import load_nyud2_split
from imbalanced_regression_tpu_torch.ops.binning import bin_index_depth


def create_fds_subset(data_dir: str, size: int = 600, seed: int | None = None) -> str:
    if seed is not None:
        np.random.seed(seed)
    with open(os.path.join(data_dir, "nyu2_train.csv"), newline="") as fh:
        rows = [row for row in csv.reader(fh) if row]
    select = np.random.choice(len(rows), size=size, replace=False)
    np.save(os.path.join(data_dir, "FDS_train_subset_id.npy"), select)
    out = os.path.join(data_dir, "nyu2_train_FDS_subset.csv")
    with open(out, "w", newline="") as fh:
        csv.writer(fh, lineterminator="\n").writerows(rows[i] for i in select)
    return out


def create_balanced_test_mask(data_dir: str, bucket_start: int = 7,
                              seed: int | None = None) -> str:
    if seed is not None:
        np.random.seed(seed)
    test = load_nyud2_split(data_dir, "nyu2_test.csv", train=False)
    depth = test["target"][..., 0]  # [N, H, W]
    flat = depth.reshape(-1)
    counts, _ = np.histogram(flat, bins=100, range=(0.0, 10.0))
    select_num = int(counts[counts != 0].min())
    bins = np.asarray(bin_index_depth(flat, 100, 0))

    mask = np.zeros(flat.shape[0], dtype=np.uint8)
    for b in range(bucket_start, 100):
        idx = np.where(bins == b)[0]
        if len(idx) == 0:
            continue
        chosen = np.random.choice(idx, size=min(select_num, len(idx)), replace=False)
        mask[chosen] = 1
    out = os.path.join(data_dir, "test_balanced_mask.npy")
    np.save(out, mask.reshape(depth.shape))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--subset_size", type=int, default=600)
    args = parser.parse_args(argv)
    print("FDS subset:", create_fds_subset(args.data_dir, args.subset_size, args.seed))
    print("Balanced mask:", create_balanced_test_mask(args.data_dir, seed=args.seed))


if __name__ == "__main__":
    main()
