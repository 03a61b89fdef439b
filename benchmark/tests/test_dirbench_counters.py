"""The operation and byte counters against hand counts at small shapes."""

import numpy as np
import pytest

from dirbench import peaks, spec


def test_resnet_flops_hand_count():
    # one stage of one bottleneck (width 4, mid 4, out 16) on 8 x 8 input:
    # stem 7x7/2 -> 4 x 4 (16 pixels), pool -> 2 x 2 (4 pixels)
    stem = 16 * 3 * 4 * 49
    block = 4 * 4 * 4 + 4 * 4 * 4 * 9 + 4 * 4 * 16 + 4 * 4 * 16  # 1x1, 3x3, 1x1, projection
    head = 16
    got = spec.load_module("flops", "resnet").forward_flops(
        {"stage_sizes": [1], "width": 4}, 8)
    assert got == 2 * (stem + block + head)


def test_resnet50_at_224_is_4_1_gmac():
    got = spec.load_module("flops", "resnet").forward_flops(
        {"stage_sizes": [3, 4, 6, 3], "width": 64}, 224)
    assert 8.1e9 < got < 8.3e9


def test_bilstm_flops_hand_count():
    m = {"d_word": 3, "d_hid": 2, "n_layers": 2}
    counter = spec.load_module("flops", "bilstm_pair")
    layer0 = 2 * (2 * 8 * 3 + 2 * 8 * 2)  # both directions: input projection and recurrence
    layer1 = 2 * (2 * 8 * 4 + 2 * 8 * 2)
    assert counter.flops_per_token(m) == layer0 + layer1
    assert counter.forward_flops(m, 10, 2) == 10 * (layer0 + layer1) + 2 * 2 * 16
    full = counter.flops_per_token({"d_word": 300, "d_hid": 1500, "n_layers": 2})
    assert full == pytest.approx(151.2e6)


def test_calibrate_bytes_hand_count():
    counter = spec.load_module("bytes", "calibrate")
    e = np.array([0, 0, 1, 2, -1])
    ok = np.array([True, True, True, False, True])
    v1sum = np.array([1.0, 0.0, 2.0])  # bucket 1 gated off by its row sum
    nbytes, elems = counter.calibrate_bytes(4, e, ok, v1sum, d=8, tables=4)
    # x and out 5 x 8 x (4 + 4), e 5 x 4, ok 5, one bucket on (bucket 0) of 4 tables + v1sum
    assert nbytes == 5 * 8 * 8 + 20 + 5 + (4 * 8 * 4 + 4)
    assert elems == 2 * 8
    call = {"x_elt": 4, "e": e, "ok": ok, "v1sum": v1sum, "d": 8, "tables": 4,
            "flops_per_elt": 8}
    assert counter.least_seconds(call) == peaks.least_seconds(nbytes, 8 * elems)


def test_moments_bound_hand_count():
    counter = spec.load_module("bytes", "moments")
    nbytes, flops = counter.moments_bound(6, 8, d=4, b=3)
    assert nbytes == 6 * 4 * 4 + 8 * 4 + 3 * 4 + 2 * 3 * 4 * 4
    assert flops == 3 * 6 * 4
