"""The control of ``correct``: the reference computed in float8 (one step
below the bfloat16 the configurations state) in the program's place reads
far above the program. On the CPU at a small size; on the card at each
cell's own size (``cuda``), against the cell's limits."""

import pytest
import torch

import readings
from dirbench import compare, spec
from tiny import SEED, TINY


def test_control_reads_above_the_program():
    # the BiLSTM: at the ResNet's CPU size (32 x 32, batch 8) its 1 x 1 last
    # stage normalizes over 8 values, and bf16 on the CPU reads as far off
    # as float8; the ResNet cells' control is read on the card
    cell = "stsb-bilstm.b128"
    torch.set_num_threads(2)
    sound = readings.reading(cell, SEED, "sound", "cpu", TINY[cell])["numbers"]
    control = readings.reading(cell, SEED, "control", "cpu", TINY[cell])["numbers"]
    assert any(control[k] >= 3 * sound[k] for k in ("grad1_gap", "fds_stats_gap"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in spec.load_spec()["workloads"]])
def test_control_fails_the_limits_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    limits = spec.load_json("limits", cell)
    for i in range(3):
        numbers = readings.reading(cell, readings.FIRST_SEED + 900 + i, "control")["numbers"]
        correct, _ = compare.judge(numbers, limits)
        assert not correct, numbers
