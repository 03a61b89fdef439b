"""Bytes and operations of the segment-moments kernel (K3) for one call,
as ``chip_smoke.py``'s ``moments_bound`` counts them: every index and the
features of the rows inside the buckets in once, the counts, sums and sums
of squares out once; 3 float32 operations a valid element."""

from __future__ import annotations

from dirbench.peaks import least_seconds as _least


def moments_bound(n_valid: int, n: int, d: int, b: int) -> tuple[float, float]:
    """(bytes, float32 operations) of one call (float32 features)."""
    return n_valid * d * 4 + n * 4 + b * 4 + 2 * b * d * 4, 3 * n_valid * d


def least_seconds(call: dict) -> float:
    """The least time of one call ``{n_valid, n, d, b}``."""
    return _least(*moments_bound(call["n_valid"], call["n"], call["d"], call["b"]))
