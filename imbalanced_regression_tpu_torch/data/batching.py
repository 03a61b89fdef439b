"""Batching of host numpy datasets.

Training shuffles and drops the remainder batch, so every train step sees
the same batch shape (as in the JAX package, where a new shape would
recompile the step); evaluation pads the final batch and carries a
``count`` so metrics ignore the padding. Batch dicts may be nested (STS-B's
``input`` holds the token and mask arrays of both sentences): every leaf is
indexed along its leading axis, as the JAX package's ``jax.tree.map``
does."""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np


def tree_map(fn: Callable, data):
    """``fn`` applied to every leaf of a nested dict, in a dict of the same
    structure."""
    if isinstance(data, dict):
        return {k: tree_map(fn, v) for k, v in data.items()}
    return fn(data)


def _first_leaf(data):
    while isinstance(data, dict):
        data = next(iter(data.values()))
    return data


def _num_examples(data: dict) -> int:
    return len(_first_leaf(data))


def _take(data: dict, sel) -> dict:
    return tree_map(lambda v: v[sel], data)


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
    skip: int = 0,
) -> Iterator[dict]:
    """Yield dict batches from a (possibly nested) dict of equal-length
    arrays. The first ``skip`` batches of the shuffled order are left out
    without gathering their rows (a stream-mode image array never decodes
    them); the rest are the batches the full stream yields after them."""
    n = _num_examples(data)
    batches = index_iterator(n, batch_size, shuffle=shuffle, rng=rng, drop_last=drop_last)
    for i, idx in enumerate(batches):
        if i >= skip:
            yield _take(data, idx)


def infinite_index_batches(
    n: int, batch_size: int, seed: int, start_batches: int = 0
) -> Iterator[tuple[np.ndarray, int]]:
    """Endless reshuffled epochs of index batches; yields (idx, epoch).

    Epoch ``e`` shuffles with ``np.random.default_rng((seed, e))`` and drops
    the remainder, so a stream restarted with ``start_batches=k`` yields
    what the uninterrupted one yields from batch k on. For ``n <
    batch_size`` each epoch is one short batch of all ``n`` rows (dropping
    the remainder would leave none)."""
    drop_last = n >= batch_size
    n_batches = max(n // batch_size, 1)
    epoch, skip = divmod(start_batches, n_batches)
    while True:
        rng = np.random.default_rng((seed, epoch))
        for i, idx in enumerate(index_iterator(n, batch_size, rng=rng, drop_last=drop_last)):
            if i >= skip:
                yield idx, epoch
        skip = 0
        epoch += 1


def infinite_batches(
    data: dict, batch_size: int, seed: int, start_batches: int = 0
) -> Iterator[tuple[dict, int]]:
    """:func:`infinite_index_batches` with the rows gathered from ``data``
    (the STS-B trainer's endless generator, ``sts-b-dir/trainer.py:83``);
    yields (batch, epoch)."""
    n = _num_examples(data)
    for idx, epoch in infinite_index_batches(n, batch_size, seed, start_batches):
        yield _take(data, idx), epoch


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
            batch = tree_map(lambda v: np.concatenate([v, np.repeat(v[:1], pad, axis=0)]), batch)
        batch["count"] = count
        yield batch
