"""Age-suite (IMDB-WIKI-DIR / AgeDB-DIR) data pipeline on real files.

The port's counterpart of the JAX package's ``data/age.py`` (reference
``imdb-wiki-dir/datasets.py:14-53``): a meta CSV with ``age,path,split``
columns points at face images, which are decoded and resized once on the
host to uint8 NHWC (augmentation runs on the device, ``data/augment.py``).
The CSV is read with the standard ``csv`` module by header name, in file
order; the rows, the splits and their order are those of ``pd.read_csv``
on the same file. The image column is a ram, mmap or stream array
(``data/streaming.py``), chosen by :func:`choose_data_mode`.

LDS / re-weighting enters as per-sample weights
(:func:`ops.lds.prepare_weights_age`), the reference's ``_prepare_weights``.
"""

from __future__ import annotations

import csv
import logging
import os

import numpy as np

from imbalanced_regression_tpu_torch.data.native_loader import decode_resize_batch
from imbalanced_regression_tpu_torch.data.streaming import (
    LazyImageArray,
    build_mmap_cache,
    choose_data_mode,
)
from imbalanced_regression_tpu_torch.ops.lds import prepare_weights_age

logger = logging.getLogger(__name__)

SPLITS = ("train", "val", "test")


def read_meta_csv(path: str) -> dict[str, list[dict]]:
    """The CSV's rows by split, in file order (blank lines skipped, as
    pandas skips them)."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    missing = {"age", "path", "split"} - set(rows[0] if rows else {})
    if missing:
        raise ValueError(f"{path}: missing column(s) {sorted(missing)}")
    return {s: [r for r in rows if r["split"] == s] for s in SPLITS}


def _ages(rows: list[dict]) -> np.ndarray:
    """The ``age`` column as pandas infers it: int64 when every value is an
    integer, else float64."""
    values = [r["age"] for r in rows]
    try:
        return np.asarray([int(v) for v in values], np.int64)
    except ValueError:
        return np.asarray([float(v) for v in values], np.float64)


def load_split(rows: list[dict], data_dir: str, img_size: int, workers: int = 8,
               mode: str = "ram", cache_dir: str | None = None) -> dict:
    """One split as ``{'input', 'target'}``: ``ram`` decodes every image
    now, ``mmap`` decodes once into an on-disk uint8 cache and memory-maps
    it, ``stream`` decodes on access (:class:`LazyImageArray`); all three
    index alike downstream. ``target`` is float32 [N, 1]."""
    paths = [os.path.join(data_dir, r["path"]) for r in rows]
    if mode == "stream":
        images = LazyImageArray(paths, img_size, threads=workers)
    elif mode == "mmap":
        images = build_mmap_cache(paths, img_size, cache_dir or os.path.join(data_dir, "_cache"),
                                  threads=workers)
    else:
        images = decode_resize_batch(paths, img_size, threads=workers)
    return {"input": images, "target": _ages(rows).astype(np.float32)[:, None]}


def load_age_datasets(config) -> tuple[dict, dict, dict, np.ndarray]:
    """(train, val, test) dict datasets and the raw train labels, from
    ``{data_dir}/{dataset}.csv``.

    ``train['weight']`` carries the LDS / re-weighting per-sample weights
    (ones when ``reweight == 'none'``, the reference's weight fallback,
    ``datasets.py:34``)."""
    csv_path = os.path.join(config.data_dir, f"{config.dataset}.csv")
    if not os.path.exists(csv_path):
        raise FileNotFoundError(
            f"Meta CSV {csv_path!r} not found. Build it with tools/create_age_meta.py "
            f"+ tools/make_balanced_splits.py, or pass --synthetic_size N for a "
            f"synthetic stand-in.")
    splits = read_meta_csv(csv_path)
    logger.info("Loaded %s: train=%d val=%d test=%d", csv_path, *(len(splits[s]) for s in SPLITS))
    mode = choose_data_mode(sum(len(rows) for rows in splits.values()), config.img_size,
                            config.data_mode, config.ram_budget_gb)
    if mode != "ram":
        logger.info("Bounded-memory image mode: %s", mode)
    datasets = {s: load_split(splits[s], config.data_dir, config.img_size, config.workers,
                              mode=mode, cache_dir=config.cache_dir or None)
                for s in SPLITS}
    train_labels = _ages(splits["train"])
    weights = prepare_weights_age(
        train_labels, config.reweight, max_target=config.max_target, lds=config.lds,
        lds_kernel=config.lds_kernel, lds_ks=config.lds_ks, lds_sigma=config.lds_sigma)
    n = len(train_labels)
    datasets["train"]["weight"] = (weights[:, None].astype(np.float32) if weights is not None
                                   else np.ones((n, 1), np.float32))
    return datasets["train"], datasets["val"], datasets["test"], train_labels
