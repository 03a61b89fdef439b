"""The port's spans (``utils/logging_tools.py`` ``recorder``) as the
Trainer records them: which spans each call opens, their parents, epochs
and rows, the bounded ring, the clock, the switch that turns recording off
(with results bit-equal either way), the profiler ranges, and on the card
the completion events (no synchronization added, no event made in a step,
intervals resolved as the ring comes round).

This file imports neither jax nor the JAX package, so its ``cuda`` tests
also run on a machine with only PyTorch:

    python -m pytest --noconftest tests/test_torch_spans.py -q -m cuda
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.models.resnet import RegressionHead, ResNetBackbone
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig
from imbalanced_regression_tpu_torch.utils import logging_tools
from imbalanced_regression_tpu_torch.utils.logging_tools import SpanRecorder, recorder, step_log

ROWS, IMG = 8, 16


@pytest.fixture(autouse=True)
def _few_threads_and_recording_on():
    """Two intra-op threads (the suite runs in several worker processes at
    once), and the recorder's switch put back after each test."""
    before, enabled = torch.get_num_threads(), recorder.enabled
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
    recorder.enabled = enabled


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none. Decided
    when the test runs, never at import, so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


def _trainer(device="cpu", seed=0):
    trainer = Trainer(ResNetBackbone(stage_sizes=(1, 1), width=8, dtype=torch.float32),
                      RegressionHead(64), TrainerConfig(loss="l1", lr=1e-3),
                      fds_config=FDSConfig.for_age(feature_dim=64, bucket_num=121), device=device)
    return trainer, trainer.init_state(seed)


def _batches(k, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input": rng.uniform(0, 255, (ROWS, IMG, IMG, 3)).astype(np.float32),
             "target": rng.uniform(0, 100, (ROWS, 1)).astype(np.float32),
             "weight": rng.uniform(0.5, 2, (ROWS, 1)).astype(np.float32)} for _ in range(k)]


def _names(spans):
    return [s.name for s in spans]


def test_train_epoch_records_epoch_steps_and_waits():
    trainer, state = _trainer()
    t0 = time.time_ns()
    state, _ = trainer.train_epoch(state, iter(_batches(3)), 4)
    spans = recorder.closed(trainer=trainer.trace_id)
    assert _names(spans) == ["input_wait", "step"] * 3 + ["readback", "train_epoch"]
    epoch = spans[-1]
    assert epoch.parent is None and epoch.rows == -1
    assert all(s.parent is epoch for s in spans[:-1])
    assert all(s.epoch == 4 and s.trainer == trainer.trace_id for s in spans)
    assert [s.rows for s in spans[:6]] == [ROWS] * 6
    assert all(t0 <= s.start_ns <= s.end_ns for s in spans)
    assert all(epoch.start_ns <= s.start_ns and s.end_ns <= epoch.end_ns for s in spans[:-1])
    # on the CPU a step completes when its span closes: the interval from
    # the previous step's end to its own
    steps = [s for s in spans if s.name == "step"]
    assert steps[0].interval_ms is None
    for prev, s in zip(steps, steps[1:]):
        assert s.interval_ms == pytest.approx((s.end_ns - prev.end_ns) / 1e6)
        assert s.interval_ms > 0 and s.event is None
    # the next epoch's first step has no interval from this epoch's last
    state, _ = trainer.train_epoch(state, iter(_batches(2, seed=1)), 5)
    steps = recorder.closed("step", trainer=trainer.trace_id, epochs={5})
    assert steps[0].interval_ms is None and steps[1].interval_ms > 0


def test_indexed_step_records_gather_then_step():
    trainer, state = _trainer()
    b = _batches(1)[0]
    trainer.bind_device_data({k: np.concatenate([v, v]) for k, v in b.items()})
    trainer.train_step_indexed(state, np.arange(5), 3)
    gather, step = recorder.closed(trainer=trainer.trace_id)
    assert (gather.name, step.name) == ("gather", "step")
    assert gather.end_ns <= step.start_ns
    assert gather.parent is None and step.parent is None
    assert (gather.epoch, gather.rows, step.epoch, step.rows) == (3, 5, 3, 5)


def test_stats_passes_and_predict_record_their_spans():
    trainer, state = _trainer()
    state = trainer.fds_epoch_pass(state, iter(_batches(2)), 2)
    spans = recorder.closed(trainer=trainer.trace_id)
    # each batch's wait, then the batch (a pass_batch span)
    assert _names(spans) == ["input_wait", "pass_batch"] * 2 + ["fds_pass"]
    assert all(s.parent is spans[-1] for s in spans[:4]) and spans[-1].parent is None
    assert all(s.epoch == 2 for s in spans) and [s.rows for s in spans[1:4:2]] == [ROWS] * 2
    data = {k: np.concatenate([v, v]) for k, v in _batches(1)[0].items()}
    trainer.bind_device_data(data)
    state = trainer.fds_epoch_pass_indexed(state, iter([np.arange(4), np.arange(4, 12)]), 3)
    spans = recorder.closed(trainer=trainer.trace_id, epochs={3})
    assert _names(spans) == ["gather", "pass_batch"] * 2 + ["fds_pass"]
    assert [s.rows for s in spans[:4]] == [4, 4, 8, 8]
    assert all(s.parent is spans[-1] for s in spans[:4])
    # predictions carry the epoch the trainer last passed in; one read-back
    # a batch
    preds, _ = trainer.predict(state, iter(_batches(3, seed=2)))
    assert preds.shape == (3 * ROWS, 1)
    spans = recorder.closed("predict", "readback", trainer=trainer.trace_id)
    assert _names(spans) == ["readback"] * 3 + ["predict"]
    assert all(s.parent is spans[-1] and s.rows == ROWS for s in spans[:3])
    assert all(s.epoch == 3 for s in spans)


def test_newest_trainer_is_read_by_default():
    first, state = _trainer()
    first.train_step(state, _batches(1)[0], 0)
    second, state2 = _trainer()
    assert recorder.newest == second.trace_id > first.trace_id
    assert recorder.closed() == []
    second.train_step(state2, _batches(1)[0], 0)
    assert [s.trainer for s in recorder.closed()] == [second.trace_id]
    assert len(recorder.closed(trainer=first.trace_id)) == 1


def test_ring_stays_bounded():
    spans = SpanRecorder(capacity=5)
    for i in range(12):
        with spans.span("step", 0, epoch=i):
            pass
    assert len(spans.records) == 5
    assert [s.epoch for s in spans.closed(trainer=0)] == [7, 8, 9, 10, 11]
    assert logging_tools.recorder.records.maxlen == 1 << 16


def test_parents_are_per_thread():
    spans = SpanRecorder()
    inner = {}

    def other():
        with spans.span("predict", 0) as s:
            inner["other"] = s

    with spans.span("train_epoch", 0) as outer:
        with spans.span("step", 0) as step:
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=60)
        assert not t.is_alive()
    assert step.parent is outer and outer.parent is None
    assert inner["other"].parent is None and inner["other"].thread != outer.thread
    assert outer.thread == threading.get_ident()


def test_recording_off_records_nothing_and_changes_no_result():
    runs = []
    for enabled in (True, False):
        recorder.enabled = enabled
        trainer, state = _trainer(seed=7)
        state, loss = trainer.train_epoch(state, iter(_batches(3, seed=3)), 1)
        state = trainer.fds_epoch_pass(state, iter(_batches(2, seed=4)), 1)
        preds, _ = trainer.predict(state, iter(_batches(2, seed=5)))
        runs.append((loss, preds, {k: v.clone() for k, v in state.backbone.state_dict().items()},
                     len(recorder.closed(trainer=trainer.trace_id))))
    (loss_on, preds_on, weights_on, n_on), (loss_off, preds_off, weights_off, n_off) = runs
    # train_epoch: 3 waits, 3 steps, the read-back, the epoch; the pass: 2
    # waits, 2 batches and itself; predict: 2 read-backs and itself
    assert n_on == (3 * 2 + 2) + (2 * 2 + 1) + (2 + 1) and n_off == 0
    assert loss_on == loss_off
    np.testing.assert_array_equal(preds_on, preds_off)
    assert all(torch.equal(weights_on[k], weights_off[k]) for k in weights_on)


def test_step_log_is_the_median_step_and_the_waits():
    trainer, state = _trainer()
    state, _ = trainer.train_epoch(state, iter(_batches(3)), 6)
    state = trainer.fds_epoch_pass(state, iter(_batches(2)), 6)
    spans = recorder.closed("step", "input_wait", trainer=trainer.trace_id, epochs={6})
    log = step_log(spans)
    steps = sorted(s.ms for s in spans if s.name == "step")
    assert log["step_host_ms"] == steps[1]
    waits = [s.ms for s in spans if s.name == "input_wait"]
    assert len(waits) == 5 and log["input_wait_seconds"] == pytest.approx(sum(waits) / 1e3)
    assert step_log([]) == {}


def test_profiler_sees_the_spans_as_ranges():
    trainer, state = _trainer()
    trainer.train_step(state, _batches(1)[0], 0)  # warm, outside the profiler
    kind = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[kind]) as prof:
        trainer.train_epoch(state, iter(_batches(2)), 0)
    names = {e.key for e in prof.key_averages()}
    assert {"train_epoch", "step", "input_wait", "readback"} <= names
    with recorder.span("step", trainer.trace_id) as span:
        assert span._range is None  # no profiler: no range


@pytest.mark.cuda
def test_recorder_adds_no_synchronization_and_makes_no_event(cuda_device, monkeypatch):
    batches = _batches(3)
    trainer, state = _trainer(cuda_device)
    made, counts = [], {}

    def steps():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for b in batches:
                    trainer.train_step(state, b, 1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(cuda_device)
        return [str(w.message) for w in caught if "synchroniz" in str(w.message)]

    steps()  # warm: kernels loaded, allocator filled, what happens once done

    class CountingEvent(torch.cuda.Event):
        def __new__(cls, *args, **kwargs):
            made.append(1)
            return super().__new__(cls, *args, **kwargs)

    for enabled in (True, False):
        recorder.enabled = enabled
        monkeypatch.setattr(torch.cuda, "Event", CountingEvent)
        counts[enabled] = steps()
        monkeypatch.undo()
    assert len(counts[True]) == len(counts[False]), counts
    assert made == []  # the completion events come from the trainer's ring
    recorded = recorder.closed("step", trainer=trainer.trace_id, epochs={1})
    assert len(recorded) == 6  # the warm run's and the run with recording on
    assert all(s.interval_ms > 0 for s in recorded[1:])


@pytest.mark.cuda
def test_completion_ring_resolves_as_it_comes_round(cuda_device, monkeypatch):
    monkeypatch.setattr(logging_tools, "COMPLETION_EVENTS", 4)
    trainer, state = _trainer(cuda_device)
    ring = list(recorder._completions[trainer.trace_id].events)
    assert len(ring) == 4
    batches = _batches(2)
    for i in range(10):
        trainer.train_step(state, batches[i % 2], 0)
        torch.cuda.synchronize(cuda_device)
    # six slots came round before any read: their intervals were read then
    steps = [s for s in recorder.records if s.trainer == trainer.trace_id]
    assert sum(s.interval_ms is not None for s in steps) == 6
    steps = recorder.closed("step", trainer=trainer.trace_id)
    assert steps[0].interval_ms is None and all(s.interval_ms > 0 for s in steps[1:])
    assert recorder._completions[trainer.trace_id].events == ring
    # after the epoch's read-back every event has completed: a read gives
    # every interval but the epoch's first
    state, _ = trainer.train_epoch(state, iter(_batches(3)), 1)
    steps = recorder.closed("step", trainer=trainer.trace_id, epochs={1})
    assert [s.interval_ms is not None for s in steps] == [False, True, True]
