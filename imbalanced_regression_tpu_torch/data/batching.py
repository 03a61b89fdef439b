"""Batching of host numpy datasets.

Training shuffles and drops the remainder batch, so every train step sees
the same batch shape (as in the JAX package, where a new shape would
recompile the step); evaluation pads the final batch and carries a
``count`` so metrics ignore the padding. Batches are flat dicts of numpy
arrays, indexed along their leading axis."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def _num_examples(data: dict) -> int:
    return len(next(iter(data.values())))


def _take(data: dict, sel) -> dict:
    return {k: v[sel] for k, v in data.items()}


def index_iterator(
    n: int,
    batch_size: int,
    *,
    shuffle: bool = True,
    rng: np.random.Generator | None = None,
    drop_last: bool = True,
) -> Iterator[np.ndarray]:
    """Yield index batches over ``n`` rows — the single source of batch
    order, so every iterator built on it sees the same shuffle stream from
    the same rng."""
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    end = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, end, batch_size):
        yield idx[start : start + batch_size]


def batch_iterator(
    data: dict,
    batch_size: int,
    *,
    shuffle: bool = True,
    rng: np.random.Generator | None = None,
    drop_last: bool = True,
) -> Iterator[dict]:
    """Yield dict batches from a dict of equal-length arrays."""
    n = _num_examples(data)
    for idx in index_iterator(n, batch_size, shuffle=shuffle, rng=rng, drop_last=drop_last):
        yield _take(data, idx)


def eval_batches(data: dict, batch_size: int) -> Iterator[dict]:
    """Fixed-shape eval batches: the final batch is padded by repeating its
    first row and annotated with the true ``count``."""
    n = _num_examples(data)
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        batch = _take(data, slice(start, stop))
        count = stop - start
        if count < batch_size:
            pad = batch_size - count
            batch = {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)]) for k, v in batch.items()}
        batch["count"] = count
        yield batch
