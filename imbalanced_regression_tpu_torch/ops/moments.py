"""Per-bucket feature moments (count, sum, sum-of-squares) over a batch.

This replaces the reference's per-unique-label Python loops
(``imdb-wiki-dir/fds.py:91-111``) with dense segment moments. Moments are
*additive*, so they can be

- accumulated across batches of the epoch-end FDS feature pass (equivalent to
  the reference's gather-everything-then-update, without materializing the
  full [dataset, D] encoding array), and
- reduced across data-parallel shards (all-reduce): count-weighted sums
  match the gathered single-device computation exactly.

``mean``/``var`` recover torch semantics: unbiased variance for n > 1,
zero for n == 1 (``torch.var(..., unbiased=False)`` of one sample).

On a CUDA tensor the moments come from the segment-moments kernel (K3,
``ops/cuda_kernels.py``), or with ``use_kernel="v2"`` from the
split-precision tensor-core kernel (K4); on the CPU from their plain
versions, one-hot contractions.
"""

from __future__ import annotations

import dataclasses

import torch

from imbalanced_regression_tpu_torch.ops.cuda_kernels import segment_moments, segment_moments_v2


@dataclasses.dataclass
class BucketMoments:
    count: torch.Tensor  # [B] float32
    total: torch.Tensor  # [B, D] float32
    total_sq: torch.Tensor  # [B, D] float32
    # Presence of the *exact* edge labels in the batch — gates edge-bucket
    # updates for the age grouping (imdb-wiki-dir/fds.py:94-97). Always True
    # for pre-binned groupings. 0-d bool tensors kept on the device, so
    # accumulating them needs no host sync.
    has_lo: torch.Tensor
    has_hi: torch.Tensor

    def add_(self, other: "BucketMoments") -> "BucketMoments":
        """Accumulate ``other`` into ``self``'s tensors: counts and sums
        added, edge gates or-ed."""
        self.count.add_(other.count)
        self.total.add_(other.total)
        self.total_sq.add_(other.total_sq)
        self.has_lo.logical_or_(other.has_lo)
        self.has_hi.logical_or_(other.has_hi)
        return self

    def zero_(self) -> "BucketMoments":
        """The identity (:func:`zero_moments`) in ``self``'s tensors."""
        for t in (self.count, self.total, self.total_sq, self.has_lo, self.has_hi):
            t.zero_()
        return self

    def mean_var(self):
        """Per-bucket mean and (torch-semantics) variance; NaN-free for n=0."""
        n = self.count[:, None]
        mean = self.total / torch.clamp(n, min=1.0)
        # unbiased for n > 1; exactly/numerically ~0 for n == 1
        var = (self.total_sq - n * mean**2) / torch.clamp(n - 1.0, min=1.0)
        var = torch.clamp(var, min=0.0)  # clamp negative fp residue
        return mean, var


def bucket_moments(
    features: torch.Tensor,
    bucket_idx: torch.Tensor,
    num_buckets: int,
    *,
    valid=None,
    edge_labels=None,
    use_kernel: str | None = None,
) -> BucketMoments:
    """Compute per-bucket moments of ``features`` [N, D] grouped by
    ``bucket_idx`` [N] int32 in [0, num_buckets).

    ``valid`` optionally masks out samples (e.g. padding) — masked samples
    contribute to no bucket. ``edge_labels`` is an optional pair of [N] bool
    tensors (is_exactly_lo, is_exactly_hi) used to compute the age-grouping
    edge gates; defaults to always-on gates. ``use_kernel`` selects the
    kernel: None = the segment-moments kernel (K3), ``"v2"`` = the
    split-precision kernel (K4, on float32 features, as the JAX
    ``use_pallas="v2"``); each runs its plain version for a CPU tensor.
    """
    if use_kernel is None:
        kernel = segment_moments
    elif use_kernel == "v2":
        kernel, features = segment_moments_v2, features.to(torch.float32)
    else:
        raise ValueError(f"use_kernel must be None or 'v2', got {use_kernel!r}")
    idx = bucket_idx.to(torch.int32)
    if valid is not None:
        idx = torch.where(valid, idx, torch.full_like(idx, -1))
    count, total, total_sq = kernel(features.contiguous(), idx.contiguous(), num_buckets)

    if edge_labels is not None:
        is_lo, is_hi = edge_labels
        if valid is not None:
            is_lo = is_lo & valid
            is_hi = is_hi & valid
        has_lo = is_lo.any()
        has_hi = is_hi.any()
    else:
        has_lo = torch.ones((), dtype=torch.bool, device=features.device)
        has_hi = torch.ones((), dtype=torch.bool, device=features.device)

    return BucketMoments(count=count, total=total, total_sq=total_sq, has_lo=has_lo, has_hi=has_hi)


def all_reduce_moments(moments: BucketMoments, mesh) -> BucketMoments:
    """The moments of the global batch from each rank's, on every rank of a
    data-parallel ``mesh`` (:mod:`parallel.mesh`): ``count``, ``total`` and
    ``total_sq`` summed in one all-reduce, ``has_lo`` / ``has_hi`` or-ed
    (an all-reduce MAX; one rank may be the only one to see an edge
    label)."""
    d = moments.total.shape[1]
    flat = mesh.all_reduce(torch.cat([moments.count[:, None], moments.total, moments.total_sq],
                                     dim=1))
    flags = mesh.all_reduce(torch.stack([moments.has_lo, moments.has_hi]).to(torch.int32),
                            op="max").bool()
    return BucketMoments(count=flat[:, 0].contiguous(), total=flat[:, 1:1 + d].contiguous(),
                         total_sq=flat[:, 1 + d:].contiguous(), has_lo=flags[0], has_hi=flags[1])


def zero_moments(num_buckets: int, feature_dim: int, device="cuda") -> BucketMoments:
    """Identity element for moment accumulation across batches."""
    return BucketMoments(
        count=torch.zeros((num_buckets,), dtype=torch.float32, device=device),
        total=torch.zeros((num_buckets, feature_dim), dtype=torch.float32, device=device),
        total_sq=torch.zeros((num_buckets, feature_dim), dtype=torch.float32, device=device),
        has_lo=torch.zeros((), dtype=torch.bool, device=device),
        has_hi=torch.zeros((), dtype=torch.bool, device=device),
    )
