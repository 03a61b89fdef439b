"""Bucket-axis kernel smoothing of FDS running statistics.

The reference smooths the [B, D] running mean/var along the bucket axis with a
reflect-padded ``F.conv1d`` (cross-correlation) using the sum-normalized FDS
window (``imdb-wiki-dir/fds.py:54-67``). Here it is an unrolled
slice-multiply-accumulate over the (small, static) kernel taps, in float32:
B is at most ~121 and runs once per epoch.
"""

from __future__ import annotations

import numpy as np
import torch


def reflect_pad_1d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect (no edge repeat) padding along axis 0, torch 'reflect' style."""
    if pad == 0:
        return x
    if x.shape[0] <= pad:
        raise ValueError(f"reflect pad {pad} needs axis length > pad, got {x.shape[0]}")
    top = x[1 : pad + 1].flip(0)
    bottom = x[-pad - 1 : -1].flip(0)
    return torch.cat([top, x, bottom], dim=0)


def smooth_bucket_stats(stats: torch.Tensor, window) -> torch.Tensor:
    """Cross-correlate [B, D] stats along the bucket axis with ``window``.

    ``out[b] = sum_k stats_reflectpadded[b + k] * window[k]`` — exactly
    ``F.conv1d`` on a reflect-padded input (conv1d is cross-correlation, so the
    window is *not* flipped).
    """
    window = np.asarray(window, dtype=np.float32)
    ks = window.shape[0]
    half = (ks - 1) // 2
    padded = reflect_pad_1d(stats.to(torch.float32), half)
    b = stats.shape[0]
    out = torch.zeros_like(stats, dtype=torch.float32)
    for k in range(ks):
        out = out + float(window[k]) * padded[k : k + b]
    return out
