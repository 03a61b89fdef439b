"""Observability: scalar metrics writer (JSONL), host memory readings, a
profiler trace around a block, and a NaN trap.

The reference logs scalars to TensorBoard per epoch
(``imdb-wiki-dir/train.py:219-222``, ``nyud2-dir/train.py:209``) and measures
only wall-clock meters (SURVEY.md §5.1). The rebuild adds:

- a :class:`MetricsWriter` that mirrors every scalar to a ``metrics.jsonl``
  file (machine-readable run history);
- :func:`host_memory_gb` — current and peak RSS of the process;
- :func:`profile_trace` — a ``torch.profiler`` Chrome trace of a block;
- :func:`enable_nan_debug` — raise at the first NaN, forward or backward;
- :data:`recorder` — the program's spans: timed host intervals that the
  :class:`~imbalanced_regression_tpu_torch.train.Trainer` opens around its
  steps (with a ``capture`` or ``replay`` span inside a graphed one), input
  waits, gathers, read-backs, stats passes and predictions,
  kept in memory on the device trace's clock, with a completion event for
  each step.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import statistics
import threading
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


class Span:
    """One interval of the program on the host, opened and closed by a
    ``with`` block: ``name``; ``start_ns`` and ``end_ns`` on
    ``time.time_ns``, the clock of ``torch.profiler``'s timestamps, so the
    span sits on a device trace's timeline; the ``thread`` that opened it;
    its ``parent``, the innermost span open on that thread when it opened
    (None at the top); the ``trainer`` that opened it (a
    :meth:`SpanRecorder.new_trainer` number); and the integer attributes
    ``epoch`` and ``rows`` (-1 where there is none). A ``step`` span also
    carries ``interval_ms``, the time from the completion of the same
    trainer's previous step of the same epoch to its own (None where there
    is none, or until it is resolved), and while that waits, ``event``, the
    CUDA event its completion recorded.

    While a ``torch.profiler`` session runs, the span also opens a
    ``record_function`` range of its name, so a Chrome trace shows it over
    the kernels; no range is opened otherwise."""

    __slots__ = ("name", "trainer", "epoch", "rows", "start_ns", "end_ns", "thread", "parent",
                 "event", "interval_ms", "_recorder", "_stack", "_range", "_keep")

    def __init__(self, recorder: SpanRecorder, name: str, trainer: int, epoch: int, rows: int):
        self._recorder, self.name, self.trainer, self.epoch, self.rows = (
            recorder, name, trainer, epoch, rows)
        self.end_ns = self.event = self.interval_ms = self._range = None
        self._keep = True

    def __enter__(self) -> Span:
        stacks = self._recorder._stacks
        self.thread = tid = threading.get_ident()
        stack = stacks.get(tid)
        if stack is None:
            stack = stacks[tid] = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._stack = stack
        self.start_ns = time.time_ns()
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._stack.pop()
        if self._keep:
            self._recorder.records.append(self)
        return False

    def drop(self) -> None:
        """Record nothing of this span when it closes."""
        self._keep = False

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    """What :meth:`SpanRecorder.span` gives while recording is off: a
    ``with`` block that records nothing, and ignores what is set on it."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setattr__(self, name, value) -> None:
        pass

    def drop(self) -> None:
        pass


_OFF = _Off()


class _Completions:
    """The completions of one trainer's steps, and the interval between
    each two consecutive ones of an epoch.

    On CUDA each step records, on the current stream, a timing event of a
    ring of ``size`` made (and recorded once, so created) with the ring, so
    no step makes one. An event is read only when the ring comes round to
    its slot again, long after it completed, or in :meth:`resolve`, which
    reads none that has not completed (``query``): nothing here waits on
    the device. On the CPU a step completes when its span closes."""

    def __init__(self, device: torch.device, size: int):
        self.device, self.events, self.turn = device, [], 0
        if device.type == "cuda":
            self.index = device.index if device.index is not None else torch.cuda.current_device()
            self._raw = self._stream = None
            stream = self._current_stream()
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(size)]
            for event in self.events:
                event.record(stream)
        self.pending: collections.deque[Span] = collections.deque()  # steps awaiting their pair

    def _current_stream(self) -> torch.cuda.Stream:
        """The device's current stream; its Python object is made again
        only when the stream changed (making one costs microseconds, the
        raw handle a tenth of one)."""
        raw = torch._C._cuda_getCurrentRawStream(self.index)
        if raw != self._raw:
            self._raw, self._stream = raw, torch.cuda.current_stream(self.index)
        return self._stream

    def add(self, span: Span) -> None:
        if self.events:
            if len(self.pending) == len(self.events):
                self._pop()  # the oldest step's slot comes round again
            span.event = self.events[self.turn]
            self.turn = (self.turn + 1) % len(self.events)
            span.event.record(self._current_stream())
        self.pending.append(span)
        if not self.events:
            self.resolve()

    @staticmethod
    def _done(span: Span) -> bool:
        return span.event.query() if span.event is not None else span.end_ns is not None

    def _pop(self) -> None:
        """Drop the oldest pending step, first giving the next one its
        interval from it where both have completed."""
        first = self.pending.popleft()
        if self.pending:
            second = self.pending[0]
            if second.epoch == first.epoch and self._done(first) and self._done(second):
                second.interval_ms = (first.event.elapsed_time(second.event)
                                      if first.event is not None
                                      else (second.end_ns - first.end_ns) / 1e6)
        first.event = None

    def resolve(self) -> None:
        """Every interval whose two steps have completed; the last step
        stays, for the next step's interval."""
        while len(self.pending) > 1 and self._done(self.pending[0]) and self._done(self.pending[1]):
            self._pop()


COMPLETION_EVENTS = 1024  # a trainer's ring of step completion events (CUDA)
TRAINERS_KEPT = 8  # the newest trainers whose completions are kept


class SpanRecorder:
    """The program's spans, kept in memory in a ring of the newest
    ``capacity`` closed ones and never written out. Recording is on unless
    ``enabled`` is set false; a span then costs a few microseconds of host
    time and no host-device synchronization.

    Each :class:`~imbalanced_regression_tpu_torch.train.Trainer` takes a
    number from :meth:`new_trainer` and tags its spans with it, so a reader
    takes one trainer's spans (the newest's by default) where one process
    runs several."""

    def __init__(self, capacity: int = 1 << 16):
        self.enabled = True
        self.records: collections.deque[Span] = collections.deque(maxlen=capacity)
        self._stacks: dict[int, list[Span]] = {}  # the open spans of each thread
        self._numbers = itertools.count()
        self.newest = -1
        self._completions: dict[int, _Completions] = {}  # of the newest trainers

    def new_trainer(self, device: torch.device) -> int:
        """A new trainer's number, and its ring of completion events on
        ``device``."""
        number = self.newest = next(self._numbers)
        self._completions[number] = _Completions(device, COMPLETION_EVENTS)
        while len(self._completions) > TRAINERS_KEPT:
            del self._completions[next(iter(self._completions))]
        return number

    def span(self, name: str, trainer: int = -1, epoch: int = -1, rows: int = -1):
        """A ``with`` block that records one :class:`Span`."""
        if not self.enabled:
            return _OFF
        return Span(self, name, trainer, epoch, rows)

    def completed(self, span) -> None:
        """Mark the end of a step's work inside its open ``span``: on CUDA a
        completion event on the current stream."""
        completions = self._completions.get(getattr(span, "trainer", None))
        if completions is not None:
            completions.add(span)

    def closed(self, *names: str, trainer: int | None = None, epochs=None,
               since_ns: int = 0) -> list[Span]:
        """The closed spans of ``trainer`` (the newest where None), in the
        order they closed: those named ``names`` (all where none given), of
        ``epochs`` (a set; all where None), opened at or after
        ``since_ns``. Reads the trainer's completed intervals first."""
        trainer = self.newest if trainer is None else trainer
        completions = self._completions.get(trainer)
        if completions is not None:
            completions.resolve()
        return [s for s in list(self.records)
                if s.trainer == trainer and (not names or s.name in names)
                and (epochs is None or s.epoch in epochs) and s.start_ns >= since_ns]


recorder = SpanRecorder()  # the program's spans (see :class:`SpanRecorder`)


def step_log(spans: list[Span]) -> dict:
    """The operator's view of a trainer's spans, for an epoch log: the
    median ``step`` span in ms (the host's time to dispatch a step) and the
    seconds spent in ``input_wait`` (the step's and the stats pass's wait
    for a staged batch); empty where no step was recorded."""
    steps = [s.ms for s in spans if s.name == "step"]
    if not steps:
        return {}
    return {"step_host_ms": statistics.median(steps),
            "input_wait_seconds": sum(s.ms for s in spans if s.name == "input_wait") / 1e3}


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
