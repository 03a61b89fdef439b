"""The busy and idle share as a union of intervals across streams, and the
readers that take it."""

import pytest

from dirbench import spec, trace


def summary():
    # compute stream: [0, 4] and [6, 8]; a copy stream overlapping [3, 5];
    # spans: train [0, 5], pass [5, 10]
    events = [("kernel_a", 0.0, 4.0), ("copy", 3.0, 5.0), ("kernel_b", 6.0, 8.0)]
    merged = trace.merge((s, e) for _, s, e in events)
    return trace.TraceSummary(0.0, 10.0, events, merged,
                              [("train_epoch", 0.0, 5.0), ("fds_pass", 5.0, 10.0)])


def test_union_counts_overlap_once():
    s = summary()
    assert s.merged == [(0.0, 5.0), (6.0, 8.0)]
    assert s.busy_s == 7.0  # a sum of durations would say 8
    assert trace.gaps(s.merged, 0.0, 10.0) == [(5.0, 6.0), (8.0, 10.0)]


class Obs:
    def __init__(self, s):
        self.trace = s
        self.profiled = {"steps": 2, "model_flops": 989e12, "kernel_calls": []}
        self.epochs = [{"profiled": True, "phases": {"fds_pass": 0.5}}]


def test_idle_and_step_readers():
    obs = Obs(summary())
    idle = spec.load_module("metrics", "device_idle_pct").read(obs)
    assert idle == pytest.approx(30.0)
    assert spec.load_module("metrics", "step_device_ms").read(obs) == pytest.approx(2500.0)
    assert spec.load_module("metrics", "launches_per_step").read(obs) == pytest.approx(1.0)
    assert spec.load_module("metrics", "mfu_pct").read(obs) == pytest.approx(10.0)
    assert spec.load_module("metrics", "k1k2_roofline").read(obs) is None  # nothing to read


def test_stretch_reader_against_the_unprofiled_epochs():
    obs = Obs(summary())  # a profiled epoch of 10 s
    stretch = spec.load_module("metrics", "profiled_epoch_stretch")
    assert stretch.read(obs) is None  # no unprofiled epoch to set it against
    obs.epochs += [{"profiled": False, "phases": {"train": t, "fds_pass": 1.0}}
                   for t in (3.0, 4.0, 9.0)]
    assert stretch.read(obs) == pytest.approx(2.0)  # over the median, 5 s


def test_breakdown_names_gaps_by_span():
    out = trace.breakdown(summary())
    assert out["device_ops"][0] == ["kernel_a", 4.0]
    assert out["idle_gaps"] == [["idle in fds_pass", 2.0], ["idle in fds_pass", 1.0]]
