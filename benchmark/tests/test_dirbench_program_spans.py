"""The readers of the program's spans (``step_host_ms``, ``step_ms_p95``,
``input_wait_ms``, ``idle_in_dispatch_pct``) on hand-made spans and a
hand-made trace summary, against values worked out by hand; without the
program's recorder (as at a commit that has none) they read nothing; and
in whole tiny runs of both cells on the CPU they return a number or
nothing and never raise."""

import json
import math
import sys
import threading
import types

import pytest
import torch

from dirbench import runner, spec, trace
from imbalanced_regression_tpu_torch.utils import logging_tools
from imbalanced_regression_tpu_torch.utils.logging_tools import Span, SpanRecorder
from tiny import SEED, TINY

NEW = ("step_host_ms", "step_ms_p95", "input_wait_ms", "idle_in_dispatch_pct")
BASE_NS = 1_700_000_000 * 10 ** 9  # a time.time_ns() of the program's spans
TRAINER = 3
MAIN = threading.main_thread().ident


@pytest.fixture
def spans(monkeypatch):
    """A fresh recorder in the program's place, whose newest trainer is
    ``TRAINER``."""
    rec = SpanRecorder()
    rec.newest = TRAINER
    monkeypatch.setattr(logging_tools, "recorder", rec)
    return rec


def add(rec, name, epoch, start_s, end_s, interval_ms=None, thread=MAIN):
    """A closed span from ``start_s`` to ``end_s`` seconds after ``BASE_NS``."""
    s = Span(rec, name, TRAINER, epoch, -1)
    s.start_ns, s.end_ns = BASE_NS + round(start_s * 1e9), BASE_NS + round(end_s * 1e9)
    s.thread, s.parent, s.interval_ms = thread, None, interval_ms
    rec.records.append(s)
    return s


class Obs:
    """The window's epochs 2 (the first, which the checked steps share), 3
    and 4, then the profiled epoch 5."""

    def __init__(self, summary=None):
        self.epochs = [{"epoch": e, "profiled": e == 5, "phases": {}} for e in (2, 3, 4, 5)]
        self.profiled, self.trace = self.epochs[-1], summary


def read(name, obs):
    return spec.load_module("metrics", name).read(obs)


def test_step_host_ms_is_the_median_of_the_window_epochs(spans):
    add(spans, "step", 2, 0.0, 0.5)  # the first epoch: left out
    for epoch, lengths in ((3, (1, 2, 3)), (4, (4, 5))):
        t = float(epoch)
        for ms in lengths:
            add(spans, "step", epoch, t, t + ms / 1e3)
            t += 0.01
    add(spans, "step", 5, 9.0, 9.1)  # the profiled epoch: left out
    add(spans, "gather", 3, 3.5, 3.6)
    assert read("step_host_ms", Obs()) == pytest.approx(3.0)


def test_step_ms_p95_takes_the_completion_intervals(spans):
    for i in range(1, 251):  # 250 intervals of 1 .. 250 ms over epochs 3 and 4
        add(spans, "step", 3 + i % 2, i, i + 0.001, interval_ms=float(i))
    add(spans, "step", 3, 300.0, 300.001)  # an epoch's first step: no interval
    add(spans, "step", 2, 0.0, 0.001, interval_ms=1e6)
    add(spans, "step", 5, 400.0, 400.001, interval_ms=1e6)
    # statistics.quantiles' 19th of 20 cuts of 1..250: 251 x 0.95 = 238.45
    assert read("step_ms_p95", Obs()) == pytest.approx(238.45)


def test_step_ms_p95_needs_enough_intervals(spans):
    for i in range(199):
        add(spans, "step", 3, i, i + 0.001, interval_ms=1.0)
    assert read("step_ms_p95", Obs()) is None


def test_input_wait_ms_is_a_mean_per_epoch(spans):
    add(spans, "input_wait", 2, 0.0, 1.0)
    add(spans, "input_wait", 3, 3.0, 3.010)
    add(spans, "input_wait", 3, 3.5, 3.520)
    add(spans, "input_wait", 4, 4.0, 4.030)
    add(spans, "input_wait", 5, 5.0, 6.0)
    add(spans, "step", 3, 3.1, 3.2)
    assert read("input_wait_ms", Obs()) == pytest.approx(30.0)


def test_input_wait_ms_reads_nothing_without_waits(spans):
    add(spans, "gather", 3, 3.0, 3.1)
    assert read("input_wait_ms", Obs()) is None


def summary():
    # the device busy over [0, 4] and [6, 8] of a 10 s window; the
    # benchmark's train span opens at 0.2 s, its stats-pass span at 6.4 s
    events = [("kernel_a", 0.0, 4.0), ("kernel_b", 6.0, 8.0)]
    merged = trace.merge((s, e) for _, s, e in events)
    return trace.TraceSummary(0.0, 10.0, events, merged,
                              [("train_epoch", 0.2, 6.0), ("fds_pass", 6.4, 9.8)])


def test_idle_in_dispatch_lays_the_spans_on_the_trace(spans):
    # program times 1 s before the trace's: the stats passes open together
    # (5.4 + 1 = 6.4), the program's train span 0.3 s after the
    # benchmark's (-0.5 + 1 = 0.5 against 0.2), the pair that would place
    # the spans 0.3 s too early; the device idles over [4, 6] and [8, 10]
    add(spans, "train_epoch", 5, -0.5, 4.9)
    add(spans, "step", 5, 0.0, 4.5)  # [1, 5.5]: idle [4, 5.5]
    add(spans, "readback", 5, 4.0, 4.2)  # [5, 5.2]: not dispatch
    add(spans, "fds_pass", 5, 5.4, 8.5)  # [6.4, 9.5]: idle [8, 9.5]
    add(spans, "input_wait", 5, 7.5, 8.0)  # [8.5, 9]: not dispatch
    add(spans, "predict", 4, -3.0, -2.0)  # another epoch: left out
    add(spans, "step", 5, 2.0, 5.0, thread=MAIN + 1)  # another thread: left out
    # (1.5 - 0.2) + (1.5 - 0.5) = 2.3 s of the 10
    assert read("idle_in_dispatch_pct", Obs(summary())) == pytest.approx(23.0)


def test_idle_in_dispatch_needs_spans_and_a_trace(spans):
    assert read("idle_in_dispatch_pct", Obs(summary())) is None
    add(spans, "fds_pass", 5, 0.0, 1.0)
    assert read("idle_in_dispatch_pct", Obs()) is None
    no_pair = summary()
    no_pair.spans = [("validate", 0.0, 1.0)]  # no program prediction to pair it with
    assert read("idle_in_dispatch_pct", Obs(no_pair)) is None
    assert read("idle_in_dispatch_pct", Obs(summary())) is not None


def test_readers_read_nothing_where_the_program_has_no_recorder(monkeypatch):
    """A program without the span recorder (an earlier commit's): its
    ``logging_tools`` has no ``recorder``."""
    bare = types.ModuleType(logging_tools.__name__)
    monkeypatch.setitem(sys.modules, logging_tools.__name__, bare)
    for name in NEW:
        assert read(name, Obs(summary())) is None


@pytest.fixture
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell,seconds", [("age-r50-agedb.b256", 0.01),
                                          ("stsb-bilstm.b128", 1.5)])
def test_tiny_traced_cells_read_a_number_or_nothing(few_threads, cell, seconds):
    result, _ = runner.run_cell(cell, SEED, seconds, True, device="cpu", overrides=TINY[cell])
    metrics = json.loads(json.dumps(result))["metrics"]
    for name in NEW:
        if name in metrics:
            assert math.isfinite(metrics[name]["value"]) and metrics[name]["value"] >= 0
    assert "idle_in_dispatch_pct" in metrics
    if cell.startswith("stsb"):  # epochs of ~1 s: the window has epochs to read
        assert metrics["step_host_ms"]["value"] > 0
