"""The reader of ``graphed_step_pct`` on hand-made spans, against shares
worked out by hand; for a program without the graphed step (as at a commit
whose ``train`` module has no ``StepGraphs``) or without the span
recorder it reads nothing; and in a whole tiny run of the STS-B cell on the
CPU, where every step runs eagerly, it reads 0."""

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


def step(rec, epoch, start_s, inner=None):
    """A ``step`` span, with a ``replay`` or ``capture`` span inside (the
    inner span closes first, as in the program)."""
    outer = Span(rec, "step", TRAINER, epoch, -1)
    if inner is not None:
        add(rec, inner, epoch, start_s, parent=outer)
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
    return spec.load_module("metrics", "graphed_step_pct").read(obs)


def test_graphed_step_pct_counts_replays_over_the_window_steps(spans):
    step(spans, 2, 0.0)  # the first epoch: its eager warm-up and capture left out
    step(spans, 2, 0.1, "capture")
    for i in range(7):  # epochs 3 and 4: 8 steps, 7 replays and one eager step
        step(spans, 3 + i % 2, 1.0 + i, "replay")
    step(spans, 4, 9.0)
    step(spans, 5, 10.0)  # the profiled epoch: left out
    step(spans, 5, 10.1)
    add(spans, "replay", 3, 11.0, trainer=TRAINER - 1)  # another trainer's
    assert read(Obs()) == pytest.approx(100.0 * 7 / 8)


def test_graphed_step_pct_reads_zero_where_no_step_replays(spans):
    for i in range(4):
        step(spans, 3, float(i))
    assert read(Obs()) == 0.0


def test_graphed_step_pct_needs_steps(spans):
    add(spans, "replay", 3, 0.0)  # a replay without its step: no window steps
    assert read(Obs()) is None


def test_graphed_step_pct_reads_nothing_without_the_graphed_step(spans, monkeypatch):
    """A parent whose program has spans but no graphed step: its steps have
    no ``replay`` span, and its ``train`` module no ``StepGraphs``."""
    for i in range(4):
        step(spans, 3, float(i))
    bare = types.ModuleType(train.__name__)
    monkeypatch.setitem(sys.modules, train.__name__, bare)
    assert read(Obs()) is None


def test_graphed_step_pct_reads_nothing_without_the_recorder(monkeypatch):
    bare = types.ModuleType(logging_tools.__name__)
    monkeypatch.setitem(sys.modules, logging_tools.__name__, bare)
    assert read(Obs()) is None


@pytest.fixture
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_tiny_stsb_cell_reads_zero_on_the_cpu(few_threads):
    cell = "stsb-bilstm.b128"
    result, _ = runner.run_cell(cell, SEED, 1.5, True, device="cpu", overrides=TINY[cell])
    metrics = json.loads(json.dumps(result))["metrics"]
    assert metrics["graphed_step_pct"] == {"value": 0.0, "unit": "%"}
