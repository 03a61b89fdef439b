"""Token dispatch and combine of the expert-parallel DeepSeekMoE layer
(``models/deepseek_v2.py`` ``MoELayer``) in plain PyTorch: the plain
versions of the CUDA kernels of ``csrc/moe_dispatch.cu``
(:func:`ops.cuda_kernels.moe_dispatch` and the three others), which the
wrappers run for CPU tensors.

A chip holds experts ``[lo, lo + held)`` of the router's; slot ``(t, j)``
is token ``t``'s ``j``-th choice of ``idx`` [T, K], held where its expert
is. The dispatch sorts the held slots by expert, stably (slot order within
an expert), and gathers each one's token row into ``xs`` [cap, D], ``cap =
T * min(K, held)`` rows (the most a step can route here: static, so that a
captured graph needs no count from the host); ``pos`` [T, K] int32 is each
slot's row (-1 where not held) and ``offs`` [held] int32 the end of each
expert's rows (``torch._grouped_mm``'s offsets). Rows from ``offs[-1]`` on
are zero here; the kernels leave them unwritten. The combine sums each
token's held rows of the products, weighted, in slot order; its backward is
one-to-one into the rows, and the dispatch's backward a gather that sums a
token's rows in slot order, so neither needs an atomic add. Sums are taken
in float32 (float64 for float64 inputs)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_capacity(tokens: int, k: int, held: int) -> int:
    """Rows of the dispatch buffer: every token may route ``min(k, held)``
    of its slots here."""
    return tokens * min(k, held)


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def moe_dispatch_plain(x, idx, lo: int, held: int, rows, touched):
    """(xs [cap, D], pos [T, K] int32, offs [held] int32) of ``x`` [T, D]
    routed by ``idx`` [T, K]; adds each held expert's rows into ``rows``
    [held] and the tokens with a held slot into ``touched`` [1] (int64
    counters)."""
    tokens, k = idx.shape
    local = idx.long() - lo
    is_held = (local >= 0) & (local < held)
    key = torch.where(is_held, local, held).reshape(-1)
    order = torch.sort(key, stable=True).indices
    per = F.one_hot(key, held + 1)[:, :held].sum(0)
    offs = per.cumsum(0).to(torch.int32)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    pos = torch.where(is_held.reshape(-1), rank, -1).view(tokens, k).to(torch.int32)
    cap = moe_capacity(tokens, k, held)
    live = torch.arange(cap, device=x.device) < offs[-1]
    xs = torch.where(live[:, None], x[order[:cap] // k], torch.zeros((), dtype=x.dtype))
    rows += per
    touched += is_held.any(1).sum()
    return xs, pos, offs


def _slot_rows(pos):
    """(held [T, K] bool, row indices [T, K] int64 clamped to 0 where not
    held)."""
    held = pos >= 0
    return held, torch.where(held, pos, 0).long()


def moe_dispatch_backward_plain(dxs, pos):
    """``dx`` [T, D] (``dxs``'s type): each token's held rows of ``dxs``
    summed in slot order in float32."""
    held, rows = _slot_rows(pos)
    acc = torch.zeros(pos.shape[0], dxs.shape[1], dtype=_acc(dxs.dtype), device=dxs.device)
    for j in range(pos.shape[1]):
        acc = acc + torch.where(held[:, j, None], dxs[rows[:, j]].to(acc.dtype), 0.0)
    return acc.to(dxs.dtype)


def moe_combine_plain(y, w, pos):
    """``out`` [T, D] float32: ``sum_j w[t, j] * y[pos[t, j]]`` over the held
    slots in slot order (``w`` [T, K] float32)."""
    held, rows = _slot_rows(pos)
    acc = torch.zeros(pos.shape[0], y.shape[1], dtype=_acc(y.dtype), device=y.device)
    for j in range(pos.shape[1]):
        term = w[:, j, None].to(acc.dtype) * y[rows[:, j]].to(acc.dtype)
        acc = acc + torch.where(held[:, j, None], term, 0.0)
    return acc


def moe_combine_backward_plain(dout, y, w, pos):
    """(dy [cap, D] in ``y``'s type, dw [T, K]) of :func:`moe_combine_plain`
    for ``dout`` [T, D]: ``dy[pos[t, j]] = w[t, j] * dout[t]``, zero in the
    rows no slot holds; ``dw[t, j] = dout[t] . y[pos[t, j]]`` in float32, 0
    where not held."""
    held, rows = _slot_rows(pos)
    cap = y.shape[0]
    dy = torch.zeros(cap + 1, y.shape[1], dtype=y.dtype, device=y.device)  # last: a dump row
    val = (w[..., None].to(dout.dtype) * dout[:, None, :]).to(y.dtype)
    dy.index_put_((torch.where(held, rows, cap).reshape(-1),), val.reshape(-1, y.shape[1]))
    dot = (dout[:, None, :].to(_acc(y.dtype)) * y[rows].to(_acc(y.dtype))).sum(-1)
    return dy[:cap], torch.where(held, dot, 0.0).to(w.dtype)
