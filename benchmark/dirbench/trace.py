"""Spans and the device trace.

The benchmark records its own spans, around its calls into the program
(:class:`Spans`), on the host's clock. A profiled epoch traces the device
alone (``torch.profiler`` with CUDA activity only: recording every host
operation as well more than doubled a host-bound epoch); the trace's
timestamps are on the same wall clock as ``time.time_ns``, so the spans
place the device's activities. :func:`summarize` reduces one profiled epoch
to what the per-layer readers need: the device's activities (kernels,
copies, sets), their union (busy time, counted once where streams
overlap), and the spans.

Every span the benchmark records ends in a device synchronization, so the
device work of a span lies inside the span's interval on the timeline."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    start: float  # time.perf_counter
    end: float
    start_ns: int  # time.time_ns, the trace's clock
    end_ns: int


class Spans:
    """The benchmark's spans, in the order they closed."""

    def __init__(self):
        self.records: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0, n0 = time.perf_counter(), time.time_ns()
        yield
        self.records.append(Span(name, t0, time.perf_counter(), n0, time.time_ns()))

    def seconds(self, last: int) -> dict:
        """The last ``last`` spans' lengths by name."""
        return {s.name: s.end - s.start for s in self.records[-last:]}


def merge(intervals):
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged, lo: float, hi: float) -> float:
    """How much of ``[lo, hi]`` the disjoint intervals ``merged`` cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def gaps(merged, lo: float, hi: float):
    """The idle intervals of ``[lo, hi]`` between the disjoint ``merged``."""
    out, t = [], lo
    for s, e in merged:
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


@dataclasses.dataclass
class TraceSummary:
    """One profiled window, times in seconds on the trace's clock."""

    start: float
    end: float
    events: list  # (name, start, end) of every device activity in the window
    merged: list  # their union
    spans: list  # (name, start, end) of the benchmark's spans

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return covered(self.merged, self.start, self.end)

    def spans_named(self, *names):
        return [s for s in self.spans if s[0] in names]

    def events_in(self, spans):
        return [e for e in self.events if any(s[1] <= e[1] < s[2] for s in spans)]

    def busy_in(self, spans) -> float:
        return sum(covered(self.merged, s[1], s[2]) for s in spans)


def profiler(device: torch.device):
    """A profiler of the device's activities only (on the CPU, which the
    tests run on, of the host's: a trace with no device activity)."""
    kind = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[kind.CUDA if device.type == "cuda" else kind.CPU])


def summarize(prof, window: Span, spans: list[Span]) -> TraceSummary:
    """The profiled ``window`` of ``prof`` (a stopped profiler): its device
    activities (kernels, copies, sets; not annotations) and the ``spans``
    inside it, in seconds from the window's start."""
    base = window.start_ns
    sec = lambda ns: (ns - base) * 1e-9  # noqa: E731
    hi = sec(window.end_ns)
    events = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or ev.is_user_annotation():
            continue
        start = sec(ev.start_ns())
        if 0.0 <= start < hi:
            events.append((ev.name(), start, start + ev.duration_ns() * 1e-9))
    events.sort(key=lambda e: e[1])
    merged = merge((s, min(e, hi)) for _, s, e in events)
    inside = [(s.name, sec(s.start_ns), sec(s.end_ns)) for s in spans
              if s is not window and base <= s.start_ns and s.end_ns <= window.end_ns]
    return TraceSummary(0.0, hi, events, merged, sorted(inside, key=lambda s: s[1]))


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the benchmark's span it falls in."""
    by_name: dict[str, float] = {}
    for name, s, e in summary.events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:top]
    idle = []
    for s, e in gaps(summary.merged, summary.start, summary.end):
        mid = (s + e) / 2
        where = next((n for n, a, b in summary.spans if a <= mid < b), "between spans")
        idle.append([f"idle in {where}", e - s])
    idle.sort(key=lambda g: g[1], reverse=True)
    return {"device_ops": [[n[:120], t] for n, t in ops], "idle_gaps": idle[:top]}
