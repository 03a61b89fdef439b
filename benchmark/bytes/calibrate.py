"""Bytes and operations of the FDS calibrate kernels (K1 forward, K2
backward) for one call, as ``chip_smoke.py``'s ``calibrate_bytes`` counts
them: x in and the float32 result out, the bucket index and the gate, and
for the rows it calibrates, each distinct bucket's rows of its ``tables``
[B, D] statistics and its ``v1sum`` entry; 8 operations a calibrated
element forward, 6 backward."""

from __future__ import annotations

import numpy as np

from dirbench.peaks import least_seconds as _least


def calibrate_bytes(x_elt: int, e, ok, v1sum, d: int, tables: int) -> tuple[float, int]:
    """(bytes, calibrated elements) of one call over rows with bucket ``e``
    [N], gate ``ok`` [N] and the bucket row sums ``v1sum`` [B]."""
    e, ok, v1sum = np.asarray(e), np.asarray(ok, bool), np.asarray(v1sum)
    n, b = e.size, v1sum.size
    valid = (e >= 0) & (e < b)
    on = valid & ok & (v1sum[np.clip(e, 0, b - 1)] >= 1e-10)
    buckets = np.unique(e[on]).size
    nbytes = n * d * x_elt + n * d * 4 + n * 4 + n + buckets * (tables * d * 4 + 4)
    return nbytes, int(on.sum()) * d


def least_seconds(call: dict) -> float:
    """The least time of one call ``{x_elt, e, ok, v1sum, d, tables,
    flops_per_elt}``."""
    nbytes, elems = calibrate_bytes(call["x_elt"], call["e"], call["ok"], call["v1sum"],
                                    call["d"], call["tables"])
    return _least(nbytes, call["flops_per_elt"] * elems)
