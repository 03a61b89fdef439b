"""Bounded-memory image input path (IMDB-WIKI scale), for the port.

A copy of the JAX package's framework-neutral ``data/streaming.py`` with the
same names and contracts; only the loader it imports is the port's
(``data/native_loader.py``). The reference streams JPEGs from disk through a
32-worker torch DataLoader (``imdb-wiki-dir/train.py:128-133``);
materializing IMDB-WIKI's 191k train images as one uint8 array would cost
~29 GB of host RAM. Three interchangeable representations of the ``input``
column bound it:

- **ram** — one in-RAM uint8 array (fastest, small corpora).
- **mmap** — a one-time decoded uint8 cache on disk (``np.memmap``); batch
  fancy-indexing touches only the pages it needs and the OS evicts them
  under pressure. Decode cost is paid once ever, not once per epoch.
- **stream** — :class:`LazyImageArray`: decode-on-access through the native
  libjpeg loader (``native/loader.cc``). No disk cache; RSS stays at a few
  batches.

All three are drop-in "array-likes" for ``data['input']``: the batching
utilities (``data/batching.py``) index them with the same fancy-index calls,
so trainers don't branch on the mode. :func:`prefetch_batches` overlaps the
host work of batch *k+1* (decode, page-in, the copy to the device) with the
device step *k*.
"""

from __future__ import annotations

import hashlib
import logging
import os
import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np

logger = logging.getLogger(__name__)


class LazyImageArray:
    """uint8 [N, S, S, 3] array-like that decodes image files on access.

    Supports the exact access patterns the batching layer uses: integer,
    slice, and integer-array indexing along the leading axis (each returns a
    freshly decoded in-RAM ndarray)."""

    def __init__(self, paths: list[str], img_size: int, threads: int | None = None):
        self.paths = list(paths)
        self.img_size = img_size
        self.threads = threads
        self.shape = (len(self.paths), img_size, img_size, 3)
        self.dtype = np.dtype(np.uint8)
        self.ndim = 4

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, sel):
        from imbalanced_regression_tpu_torch.data.native_loader import decode_resize_batch

        if isinstance(sel, (int, np.integer)):
            return decode_resize_batch([self.paths[int(sel)]], self.img_size,
                                       threads=self.threads)[0]
        if isinstance(sel, slice):
            idx = range(*sel.indices(len(self.paths)))
        else:
            idx = np.asarray(sel).reshape(-1)
        return decode_resize_batch([self.paths[int(i)] for i in idx], self.img_size,
                                   threads=self.threads)

    def __array__(self, dtype=None):  # discourage accidental materialization
        raise TypeError(
            "LazyImageArray holds the whole corpus; index it per batch instead of "
            "converting to a dense array (use data_mode='ram' for small corpora)"
        )


def corpus_signature(paths: list[str], img_size: int) -> str:
    """Content key for the decoded cache: file list + decode size."""
    h = hashlib.sha1(f"img_size={img_size}".encode())
    for p in paths:
        h.update(p.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def build_mmap_cache(
    paths: list[str],
    img_size: int,
    cache_dir: str,
    threads: int | None = None,
    chunk: int = 1024,
) -> np.ndarray:
    """Decode a corpus once into an on-disk uint8 ``.npy`` and memory-map it.

    Decoding is chunked so peak RAM stays at ``chunk`` images regardless of
    corpus size; a sidecar ``.ok`` marker guards against half-built caches
    (interrupted runs rebuild). Returns a read-only ``np.memmap``."""
    from imbalanced_regression_tpu_torch.data.native_loader import decode_resize_batch

    os.makedirs(cache_dir, exist_ok=True)
    sig = corpus_signature(paths, img_size)
    npy = os.path.join(cache_dir, f"images_{sig}.npy")
    marker = npy + ".ok"
    if not (os.path.exists(npy) and os.path.exists(marker)):
        import time

        logger.info("Building decoded-image cache: %d files -> %s", len(paths), npy)
        out = np.lib.format.open_memmap(
            npy, mode="w+", dtype=np.uint8,
            shape=(len(paths), img_size, img_size, 3),
        )
        t0 = time.monotonic()
        for start in range(0, len(paths), chunk):
            stop = min(start + chunk, len(paths))
            out[start:stop] = decode_resize_batch(paths[start:stop], img_size,
                                                  threads=threads)
            # progress heartbeat: at IMDB-WIKI scale the build runs tens of
            # minutes and a silent log would trip the babysit stall detector
            rate = stop / (time.monotonic() - t0)
            logger.info("decoded %d/%d (%.0f img/s)", stop, len(paths), rate)
        out.flush()
        del out
        with open(marker, "w") as f:
            f.write(sig)
    return np.load(npy, mmap_mode="r")


_DONE = object()


def prefetch_batches(
    batches: Iterable[dict],
    depth: int = 2,
    transform: Callable[[dict], dict] | None = None,
) -> Iterator[dict]:
    """Run an iterator's host work on a background thread, ``depth`` batches
    ahead.

    With lazy/mmap inputs the decode/page-in of batch *k+1* overlaps the
    device step of batch *k*; a ``transform`` (the trainer's
    ``_stage_batch``) also overlaps the host→device copy. Exceptions raised
    by the producer re-raise at the consuming site. Closing the generator
    early (the consumer raised, or stopped iterating) unblocks the producer
    and waits for it to stop, so no batch is staged after the close
    returns."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def produce():
        try:
            for b in batches:
                if stop.is_set():
                    return
                q.put(transform(b) if transform is not None else b)
            q.put(_DONE)
        except BaseException as e:  # surfaced on the consumer side
            q.put(e)

    t = threading.Thread(target=produce, daemon=True, name="batch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so a blocked producer can observe the stop flag and exit;
        # it puts at most one more item (the queue has room now), then sees
        # the flag before it takes another batch
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join()


def choose_data_mode(
    n_images: int, img_size: int, mode: str = "auto", ram_budget_gb: float = 8.0
) -> str:
    """Resolve ``auto``: keep corpora under the budget in RAM, else mmap."""
    if mode != "auto":
        return mode
    bytes_needed = n_images * img_size * img_size * 3
    return "ram" if bytes_needed <= ram_budget_gb * 1e9 else "mmap"
