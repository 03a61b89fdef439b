"""Observability: scalar metrics writer (JSONL), host memory readings, a
profiler trace around a block, and a NaN trap.

The reference logs scalars to TensorBoard per epoch
(``imdb-wiki-dir/train.py:219-222``, ``nyud2-dir/train.py:209``) and measures
only wall-clock meters (SURVEY.md §5.1). The rebuild adds:

- a :class:`MetricsWriter` that mirrors every scalar to a ``metrics.jsonl``
  file (machine-readable run history);
- :func:`host_memory_gb` — current and peak RSS of the process;
- :func:`profile_trace` — a ``torch.profiler`` Chrome trace of a block;
- :func:`enable_nan_debug` — raise at the first NaN, forward or backward.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class MetricsWriter:
    """Append-only scalar logger writing one JSON object per line to
    ``metrics.jsonl`` (machine-readable run history). With ``enabled``
    false (the ranks of a data-parallel run other than 0) it writes
    nothing."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self._jsonl = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step), "time": time.time()}
        ) + "\n")

    def log_dict(self, scalars: dict, step: int, prefix: str = "") -> None:
        for key, value in scalars.items():
            if isinstance(value, (int, float)):
                self.log_scalar(f"{prefix}{key}", value, step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()


def host_memory_gb() -> tuple[float, float]:
    """(current RSS, peak RSS) of this process in GB (Linux ``/proc``).

    Production observability for the bounded-memory input modes
    (``data/streaming.py``): the stream/mmap paths promise host RSS stays at
    a few batches; the epoch log records whether that holds at 191k-image
    scale. Returns (0, 0) where /proc is unavailable."""
    cur = peak = 0.0
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    cur = int(line.split()[1]) / 1e6  # kB -> GB
                elif line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) / 1e6
    except OSError:
        pass
    return cur, peak


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace (``trace_<ns>.json``, open in Perfetto or
    ``chrome://tracing``) into ``log_dir`` on exit. Yields the profiler, so
    the block's caller can also read ``key_averages()``.

    Records host (CPU) activity always and, where a card is present, its
    kernels and copies (CUPTI). The JAX counterpart (``jax.profiler``)
    writes a TensorBoard profile directory with the XLA device ops
    instead."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


# ops whose output holds memory no op has written yet (a NaN there is not
# a result)
_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize_",
              "set_"}


class _NanTrap(TorchDispatchMode):
    """Checks the floating-point outputs of every aten op that computes
    values (not the ``_UNWRITTEN`` allocations, not views, whose values an
    earlier op made) and raises ``FloatingPointError`` at the first NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _UNWRITTEN:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_nan_trap: list[_NanTrap] = []  # the trap pushed by enable_nan_debug, if on


def enable_nan_debug(enable: bool = True) -> None:
    """Raise at the first NaN an op produces, as ``jax_debug_nans`` does.

    Two mechanisms cover what JAX's flag covers. A dispatch mode checks the
    floating-point outputs of every aten op, forward and backward, run in
    this thread (and the autograd engine's threads, which inherit it) and
    raises ``FloatingPointError`` naming the op; autograd's anomaly mode
    (``check_nan=True``) records the forward trace of each backward node,
    so a backward NaN also names the forward line that made the node.
    Differences from JAX: the check runs op by op after each op (JAX
    re-runs a jitted function de-optimized to find the op); every check
    reads a flag back to the host, so the step runs many times slower; and
    the port's CUDA kernels (``ops/cuda_kernels.py``, launched through
    ``ctypes``) are no aten ops, so a NaN one of them writes is caught at
    the first op that computes from it. ``enable_nan_debug(False)`` turns
    both off.
    """
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    if enable and not _nan_trap:
        _nan_trap.append(_NanTrap())
        _nan_trap[0].__enter__()
    elif not enable and _nan_trap:
        _nan_trap.pop().__exit__(None, None, None)
