"""The reader of ``graphed_pass_pct`` on hand-made spans, against shares
worked out by hand, over the window's epochs only; with no ``pass_batch``
span (as at a commit whose stats pass opens none) or without the span
recorder it reads nothing; and in a whole tiny run of the STS-B cell on the
CPU it reads 0 where every batch runs eagerly, and 100 where stand-in
graphs take the graphed path."""

import json
import sys
import types

import pytest
import torch

from dirbench import runner, spec
from imbalanced_regression_tpu_torch import train
from imbalanced_regression_tpu_torch.utils import logging_tools
from imbalanced_regression_tpu_torch.utils.logging_tools import Span, SpanRecorder
from tiny import SEED, TINY

BASE_NS = 1_700_000_000 * 10 ** 9
TRAINER = 5


@pytest.fixture
def spans(monkeypatch):
    """A fresh recorder in the program's place, whose newest trainer is
    ``TRAINER``."""
    rec = SpanRecorder()
    rec.newest = TRAINER
    monkeypatch.setattr(logging_tools, "recorder", rec)
    return rec


def add(rec, name, epoch, start_s, parent=None, trainer=TRAINER):
    s = Span(rec, name, trainer, epoch, -1)
    s.start_ns = BASE_NS + round(start_s * 1e9)
    s.end_ns = s.start_ns + 1000
    s.thread, s.parent, s.interval_ms = 0, parent, None
    rec.records.append(s)
    return s


def batch(rec, epoch, start_s, inner=()):
    """A ``pass_batch`` span with ``inner`` spans inside (``pass_capture``,
    ``pass_replay``; they close first, as in the program)."""
    outer = Span(rec, "pass_batch", TRAINER, epoch, 128)
    for name in inner:
        add(rec, name, epoch, start_s, parent=outer)
    outer.start_ns = BASE_NS + round(start_s * 1e9)
    outer.end_ns = outer.start_ns + 2000
    outer.thread, outer.parent, outer.interval_ms = 0, None, None
    rec.records.append(outer)


class Obs:
    """The window's epochs 2 (the first, which the checked steps share), 3
    and 4, then the profiled epoch 5."""

    def __init__(self):
        self.epochs = [{"epoch": e, "profiled": e == 5, "phases": {}} for e in (2, 3, 4, 5)]
        self.profiled, self.trace = self.epochs[-1], None


def read(obs):
    return spec.load_module("metrics", "graphed_pass_pct").read(obs)


def test_graphed_pass_pct_counts_replays_over_the_window_batches(spans):
    batch(spans, 2, 0.0)  # the first epoch: its eager warm-up and capture left out
    batch(spans, 2, 0.1, ("pass_capture", "pass_replay"))
    for i in range(9):  # epochs 3 and 4: 10 batches, 9 replays and one eager batch
        batch(spans, 3 + i % 2, 1.0 + i, ("pass_replay",))
    batch(spans, 4, 10.0)
    batch(spans, 5, 11.0)  # the profiled epoch: left out
    batch(spans, 5, 11.1)
    add(spans, "pass_replay", 3, 12.0, trainer=TRAINER - 1)  # another trainer's
    add(spans, "replay", 3, 12.1)  # a graphed step's: not a pass batch
    assert read(Obs()) == pytest.approx(100.0 * 9 / 10)


def test_graphed_pass_pct_reads_zero_where_no_batch_replays(spans):
    for i in range(4):
        batch(spans, 3, float(i))
    assert read(Obs()) == 0.0


@pytest.mark.parametrize("where", ["outside the window", "none"])
def test_graphed_pass_pct_needs_window_pass_batches(spans, where):
    if where == "outside the window":
        batch(spans, 2, 0.0, ("pass_replay",))
        batch(spans, 5, 1.0, ("pass_replay",))
    add(spans, "pass_replay", 3, 2.0)  # a replay without its batch span
    assert read(Obs()) is None


def test_graphed_pass_pct_reads_nothing_at_a_parent_without_the_spans(spans):
    """A parent whose program records steps, graphed steps and the stats
    pass's span, but no ``pass_batch`` span."""
    for i in range(4):
        outer = add(spans, "step", 3, float(i))
        add(spans, "replay", 3, float(i), parent=outer)
    add(spans, "fds_pass", 3, 5.0)
    assert read(Obs()) is None


def test_graphed_pass_pct_reads_nothing_without_the_recorder(monkeypatch):
    bare = types.ModuleType(logging_tools.__name__)
    monkeypatch.setitem(sys.modules, logging_tools.__name__, bare)
    assert read(Obs()) is None


@pytest.fixture
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class StandIn:
    """A captured graph's stand-in on the CPU: ``replay`` runs the captured
    work again and writes what it returns into the static outputs."""

    def __init__(self, run, outputs):
        self.run, self.outputs = run, outputs

    def replay(self):
        for static, t in zip(self.outputs, self.run()):
            static.resize_(t.shape).copy_(t)


def _stand_in_record(self, generator, run):
    outputs = (torch.empty(0), torch.empty(0))
    return StandIn(run, outputs), outputs


@pytest.mark.parametrize("graphed,want", [(False, 0.0), (True, 100.0)])
def test_tiny_stsb_cell_reads_the_replayed_share(few_threads, monkeypatch, graphed, want):
    """Set-up's two one-batch passes warm up and capture, so every window
    batch replays where the pass is graphed."""
    if graphed:
        monkeypatch.setattr(train, "graphable", lambda device, mesh: mesh is None)
        monkeypatch.setattr(train.StepGraphs, "_record", _stand_in_record)
    cell = "stsb-bilstm.b128"
    result, _ = runner.run_cell(cell, SEED, 1.5, True, device="cpu", overrides=TINY[cell])
    metrics = json.loads(json.dumps(result))["metrics"]
    assert metrics["graphed_pass_pct"] == {"value": want, "unit": "%"}
