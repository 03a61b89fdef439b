"""Feature mean/variance calibration — the core FDS transform.

``out = (x - m1) * sqrt(clip(v2 / v1, lo, hi)) + m2`` with zero/negative
variance guards. Functional: the calibrated tensor is returned.

Two guard modes exist in the reference and both are preserved:
- ``"nonzero"``  (age suites, ``imdb-wiki-dir/utils.py:97-107``): columns with
  ``v1 == 0`` pass through unchanged.
- ``"positive"`` (STS-B ``sts-b-dir/util.py:63-73`` and NYUD2
  ``nyud2-dir/util.py:151-162``): columns need ``v1 > 0`` and ``v2 >= 0``.

In both modes an all-(near-)zero ``v1`` row (``sum(v1) < 1e-10``) disables
calibration entirely for the samples it serves.

``calibrate_gathered`` is the plain version of the calibrate kernels in
``ops/cuda_kernels.py``: the same float32 operations in the same order.
"""

from __future__ import annotations

import torch


def _col_ok(v1, v2, mode):
    if mode == "nonzero":
        return v1 != 0.0
    if mode == "positive":
        return (v1 > 0.0) & (v2 >= 0.0)
    raise ValueError(f"mode must be 'nonzero' or 'positive', got {mode!r}")


def _factor(v1, v2, clip_min, clip_max, mode):
    """(col_ok, clip(v2 / v1, lo, hi)), with v1 replaced by 1 where the
    column guard fails."""
    col_ok = _col_ok(v1, v2, mode)
    safe_v1 = torch.where(col_ok, v1, torch.ones_like(v1))
    return col_ok, torch.clamp(v2 / safe_v1, clip_min, clip_max)


def _masked_calibrate(x, m1, v1, m2, v2, clip_min, clip_max, mode):
    col_ok, factor = _factor(v1, v2, clip_min, clip_max, mode)
    out = (x - m1) * torch.sqrt(factor) + m2
    return torch.where(col_ok, out, x)


def calibrate_mean_var(
    matrix,
    m1,
    v1,
    m2,
    v2,
    clip_min: float = 0.1,
    clip_max: float = 10.0,
    mode: str = "nonzero",
):
    """Calibrate a [N, D] feature matrix with a single bucket's statistics.

    ``m1/v1`` are the bucket's running mean/var, ``m2/v2`` the smoothed
    targets, all [D]. Matches the reference ``calibrate_mean_var`` (clip range
    and guard mode are per-task config; defaults are the age-suite values).
    """
    out = _masked_calibrate(matrix, m1, v1, m2, v2, clip_min, clip_max, mode)
    row_ok = torch.sum(v1) >= 1e-10
    return torch.where(row_ok, out, matrix)


def calibrate_gathered(
    x,
    m1,
    v1,
    m2,
    v2,
    sample_ok,
    clip_min: float,
    clip_max: float,
    mode: str,
):
    """Per-sample calibration with pre-gathered bucket rows.

    ``x`` is [N, D]; ``m1/v1/m2/v2`` are [N, D] rows gathered by each sample's
    bucket; ``sample_ok`` is a [N] bool mask of samples to calibrate (edge-
    bucket gating for the age grouping; all-True otherwise). Samples whose
    gathered ``v1`` row sums below 1e-10 are left unchanged, matching the
    per-bucket early return in the reference.
    """
    out = _masked_calibrate(x, m1, v1, m2, v2, clip_min, clip_max, mode)
    row_ok = torch.sum(v1, dim=-1, keepdim=True) >= 1e-10
    ok = row_ok & sample_ok[:, None]
    return torch.where(ok, out, x)


def _indexed_rows(e, ok, v1sum, num_buckets: int):
    """Clamped gather index and the per-row gate of the calibrate kernels:
    a row is calibrated only if its bucket is in range, its ``ok`` flag is
    set and its bucket's ``v1`` row sum is at least 1e-10."""
    valid = (e >= 0) & (e < num_buckets)
    ei = torch.where(valid, e, torch.zeros_like(e)).long()
    return ei, valid & ok & (v1sum[ei] >= 1e-10)


def calibrate_indexed(x, e, ok, m1, v1, m2, v2, v1sum, clip_min: float, clip_max: float,
                      mode: str):
    """Calibration that gathers each row's bucket statistics itself: the
    plain version of the calibrate forward kernel (K1).

    ``x`` [N, D] float32 or bf16 (computed in float32); ``e`` [N] int bucket
    index, where an index outside [0, B) passes the row through; ``ok`` [N]
    bool gate; ``m1/v1/m2/v2`` [B, D]; ``v1sum`` [B] row sums of ``v1``.
    Returns float32 [N, D]. Differentiable in ``x``; its gradient is
    :func:`calibrate_indexed_grad`."""
    x = x.to(torch.float32)
    ei, row_on = _indexed_rows(e, ok, v1sum, m1.shape[0])
    col_ok, factor = _factor(v1[ei], v2[ei], clip_min, clip_max, mode)
    out = (x - m1[ei]) * torch.sqrt(factor) + m2[ei]
    return torch.where(col_ok & row_on[:, None], out, x)


def calibrate_indexed_grad(g, e, ok, v1, v2, v1sum, clip_min: float, clip_max: float,
                           mode: str):
    """``dx = g * where(mask, sqrt(factor), 1)``: the plain version of the
    calibrate backward kernel (K2). The statistics, ``e`` and ``ok`` get no
    gradient."""
    ei, row_on = _indexed_rows(e, ok, v1sum, v1.shape[0])
    col_ok, factor = _factor(v1[ei], v2[ei], clip_min, clip_max, mode)
    mask = col_ok & row_on[:, None]
    return g.to(torch.float32) * torch.where(mask, torch.sqrt(factor), torch.ones_like(factor))
