"""A whole run of each cell at a small size on the CPU (the harness's look
for a card skipped): the result line's keys, and ``correct`` false under
each fault the cell can have."""

import json
import math

import pytest
import torch

import readings
from dirbench import runner
from tiny import SEED, TINY

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(cell, traced=False, fault=None):
    def prepare(work):
        work.after_build = readings.FAULTS[fault] if fault else None

    result, rows = runner.run_cell(cell, SEED, 0.01, traced, device="cpu",
                                   overrides=TINY[cell], prepare=prepare)
    return json.loads(json.dumps(result)), rows


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    line, rows = run("stsb-bilstm.b128", traced)
    keys = list(line)
    assert keys[:5] == REQUIRED
    assert set(keys) <= set(REQUIRED) | {"breakdown", "checked"}
    assert keys[-1] == "checked"  # the compared numbers, each beside its limit, come last
    assert [r[0] for r in line["checked"]] == [r[0] for r in rows]
    if traced:
        assert "train_samples_per_s" not in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
        assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in line["metrics"].values())


CELL_FAULTS = [("age-r50-agedb.b256", "unchanged"), ("age-r50-agedb.b256", "half_batch"),
               ("age-r50-agedb.b256", "altered_answer"), ("stsb-bilstm.b128", "unchanged"),
               ("stsb-bilstm.b128", "half_batch")]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_fault_is_not_correct(cell, fault):
    line, rows = run(cell, fault=fault)
    assert line["correct"] is False
    assert line["failed"] == line["attempted"]
    assert any(v > limit for _, v, limit in rows)


def test_ring_call_sees_a_stale_slot():
    # the ResNet cells' call over several batches is where a staging slot
    # is reused; the one-batch calls before it read the same as sound
    cell = "age-r50-agedb.b256"
    sound = readings.reading(cell, SEED, "sound", "cpu", TINY[cell])["numbers"]
    stale = readings.reading(cell, SEED, "stale_slot", "cpu", TINY[cell])["numbers"]
    assert stale["loss_gap"] == sound["loss_gap"]
    assert stale["epoch_loss_gap"] > 2 * sound["epoch_loss_gap"]
