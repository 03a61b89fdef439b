"""Per-task label→bucket index functions.

Three binning schemes exist across the reference suites; all are reproduced
with their exact boundary semantics (see SURVEY.md §7 "hard parts"):

- **age** (IMDB-WIKI / AgeDB): integer truncation ``min(int(label), max-1)``
  with edge-bucket pooling handled downstream in FDS
  (``imdb-wiki-dir/datasets.py:63``, ``imdb-wiki-dir/fds.py:94-97``).
- **hist** (STS-B): ``np.histogram`` bin edges over [0, 5] — **float32**
  edges, because the reference computes them from an empty float32 array —
  first edge strictly greater than the label minus one, label == 5.0 maps to
  the last bin (``sts-b-dir/fds.py:51-57``, ``sts-b-dir/tasks.py:51-55``).
  Boundary cases hinge on float32 edge equality (e.g. float32(2.6) equals the
  float32 edge 2.6 → bin 26, where exact math would give 25), so edges are
  built exactly the reference's way and compared under numpy promotion.
- **depth** (NYUD2): ``min(int(x * float32(10)), 99)`` truncation, clamped to
  ``bucket_start`` in FDS paths (``nyud2-dir/loaddata.py:55-56``,
  ``nyud2-dir/models/fds.py:51-53``). Pure float32 math, safe on the device.

The histogram functions run on the host in numpy; ``bin_index_depth`` and
``bin_index_age`` take either a numpy array or a torch tensor and return the
same kind.
"""

from __future__ import annotations

import numpy as np
import torch


def hist_bin_edges(bucket_num: int, value_range: tuple[float, float] = (0.0, 5.0)) -> np.ndarray:
    """Histogram bin edges exactly as the reference computes them: float32,
    from ``np.histogram`` of an empty float32 array (``sts-b-dir/fds.py:53``)."""
    _, edges = np.histogram(np.array([], dtype=np.float32), bins=bucket_num, range=value_range)
    return edges


def bin_index_hist_np(
    labels,
    bucket_num: int,
    bucket_start: int = 0,
    value_range: tuple[float, float] = (0.0, 5.0),
) -> np.ndarray:
    """Host-side histogram binning with reference boundary semantics.

    ``label == range_max`` maps to the last bin; otherwise the bin is the index
    of the first edge strictly greater than the label, minus one, floored at
    ``bucket_start`` (``sts-b-dir/fds.py:51-57``).
    """
    edges = hist_bin_edges(bucket_num, value_range)
    labels = np.asarray(labels, dtype=np.float32)
    # First index where edges > label == searchsorted(side='right'); float32
    # edges vs float32 labels under numpy promotion, matching the reference's
    # `np.where(bins_edges > label)[0][0]`.
    idx = np.searchsorted(edges, labels.astype(np.float64), side="right") - 1
    idx = np.where(labels == np.float32(value_range[1]), bucket_num - 1, idx)
    return np.maximum(idx, bucket_start).astype(np.int32)


def bin_index_depth(labels, bucket_num: int = 100, bucket_start: int = 0):
    """Depth binning ``clamp(trunc(10 * x), bucket_start, bucket_num - 1)``.

    Multiplication happens in float32 and the result is truncated toward
    zero, matching ``int(x * np.float32(10))`` (``nyud2-dir/util.py:85-86``);
    the lower clamp to ``bucket_start`` matches the FDS paths
    (``nyud2-dir/models/fds.py:51-53,138-139``) — pass ``bucket_start=0`` for
    the data/eval paths which only clamp above.
    """
    if isinstance(labels, torch.Tensor):
        idx = (labels.to(torch.float32) * 10.0).to(torch.int32)  # truncates toward zero
        return idx.clamp(bucket_start, bucket_num - 1)
    scaled = np.asarray(labels).astype(np.float32) * np.float32(10.0)
    return np.clip(scaled.astype(np.int32), bucket_start, bucket_num - 1)


def bin_index_age(labels, max_target: int):
    """Age binning ``min(int(label), max_target - 1)`` (``datasets.py:63``)."""
    if isinstance(labels, torch.Tensor):
        return labels.to(torch.int32).clamp(max=max_target - 1)
    return np.minimum(np.asarray(labels).astype(np.int32), max_target - 1)
