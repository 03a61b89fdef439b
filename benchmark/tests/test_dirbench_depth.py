"""The depth cell (``depth-r50-nyud2.b32``) at a small size on the CPU:
whole runs, untraced and traced (the result line's keys, ``correct``),
``correct`` false under the control, each of ``readings.py``'s planted
faults and a mirrored test map; its counters against hand counts; and its
four readers (``test_pass_ms``, ``test_host_ms``, ``resize_ms``,
``resize_roofline``) on hand-made traces and spans."""

import json
import sys
import types

import numpy as np
import pytest
import torch

import readings
from dirbench import compare, peaks, runner, spec, trace
from imbalanced_regression_tpu_torch.utils import logging_tools
from imbalanced_regression_tpu_torch.utils.logging_tools import Span, SpanRecorder
from tiny import SEED

CELL = "depth-r50-nyud2.b32"
# ResNet stages (1, 1, 1, 1) of width 8 at 64x96, batch 4: 8 steps, a
# 4-batch stats pass and a 2-batch test an epoch; set-up's stats passes
# take two batches, as the cell's do, so a stale slot reaches them
TINY = {"model": {"stage_sizes": [1, 1, 1, 1], "width": 8, "img_hw": [64, 96],
                  "depth_hw": [32, 48]},
        "data": {"train": 32, "fds_subset": 16, "test": 6}, "recipe": {"test_batch_size": 4},
        "batch_size": 4, "setup_pass_batches": 2}


def flipped_output(trainer, state) -> None:
    """Fault: every test prediction map mirrored left to right, as a resize
    or a product with its indices reversed would leave it; every image's
    mean is kept."""
    predict_batch = trainer.predict_batch

    def flipped(*args, **kwargs):
        return np.flip(predict_batch(*args, **kwargs), axis=2).copy()

    trainer.predict_batch = flipped


FAULTS = {**readings.FAULTS, "flipped_output": flipped_output}
PLANTED = ("half_batch", "unchanged", "stats_unchanged", "stale_slot", "altered_answer",
           "flipped_output")


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(traced=False, fault=None, seconds=0.01):
    def prepare(work):
        work.after_build = FAULTS[fault] if fault else None

    result, rows = runner.run_cell(CELL, SEED, seconds, traced, device="cpu", overrides=TINY,
                                   prepare=prepare)
    return json.loads(json.dumps(result)), rows


@pytest.mark.parametrize("traced", [False, True])
def test_whole_run(traced):
    line, rows = run(traced, seconds=3.5 if traced else 0.01)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % 32 == 0
    assert [r[0] for r in line["checked"]] == list(spec.load_json("limits", CELL))
    if traced:
        metrics = line["metrics"]
        assert "train_samples_per_s" not in metrics
        # the CPU traces no device: its readers read nothing; the host's do
        assert metrics["test_pass_ms"]["value"] > 0 and metrics["test_host_ms"]["value"] > 0
        assert "resize_ms" not in metrics and "resize_roofline" not in metrics
    else:
        assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", PLANTED)
def test_fault_is_not_correct(fault):
    line, rows = run(fault=fault)
    assert line["correct"] is False and line["failed"] == line["attempted"]
    assert any(v > limit for _, v, limit in rows)


def test_control_is_not_correct():
    numbers = readings.reading(CELL, SEED, "control", "cpu", TINY)["numbers"]
    assert not compare.judge(numbers, spec.load_json("limits", CELL))[0]


# ------------------------------------------------------------------ counters

def test_depth_flops_hand_count():
    counter = spec.load_module("flops", "depth")
    m = {"stage_sizes": [1, 1, 1, 1], "width": 1, "mff_features": 1, "img_hw": [32, 32]}
    # stages of 4, 8, 16, 32 channels at 8x8, 4x4, 2x2, 1x1; D 16, 8, 4, 2, 1
    assert counter.stage_shapes(m) == [(4, 8, 8), (8, 4, 4), (16, 2, 2), (32, 1, 1)]
    enc = counter._encoder_macs(m)

    def up(cin, cout, px):
        return px * (25 * cin * cout + 9 * cout * cout + 25 * cin * cout)

    decoder = 1 * 32 * 16 + up(16, 8, 4) + up(8, 4, 16) + up(4, 2, 64) + up(2, 1, 256)
    mff = sum(up(c, 1, 256) for c in (4, 8, 16, 32)) + 256 * 25 * 16
    r = 2 * 256 * 25 * 5 * 5 + 256 * 25 * 5  # hook 1 + 4 * 1 channels
    assert counter.forward_flops(m) == 2 * (enc + decoder + mff + r)


def test_depth_flops_at_the_published_size():
    m = spec.load_json("configs", "depth-r50-nyud2")["model"]
    assert 213e9 < spec.load_module("flops", "depth").forward_flops(m) < 215e9


def test_resize_bytes_hand_count():
    counter = spec.load_module("bytes", "resize")
    call = {"n": 2, "c": 3, "h": 4, "w": 5, "H": 8, "W": 10}
    x, t, y = 2 * 4 * 5 * 3, 2 * 4 * 10 * 3, 2 * 8 * 10 * 3
    width = ((x + t + 10 * 5) * 2, 2.0 * 2 * 4 * 10 * 5 * 3)
    height = ((t + y + 8 * 4) * 2, 2.0 * 2 * 8 * 4 * 10 * 3)
    assert counter.products(call) == [width, height, height, width]
    want = 2 * (peaks.least_seconds(width[0], 0.0, width[1])
                + peaks.least_seconds(height[0], 0.0, height[1]))
    assert counter.least_seconds(call) == pytest.approx(want)
    m = spec.load_json("configs", "depth-r50-nyud2")["model"]
    calls = counter.resizes(m)
    assert len(calls) == 8 and calls[3] == {"c": 128, "h": 57, "w": 76, "H": 114, "W": 152}
    nbytes = sum(b for c in calls for b, _ in counter.products({"n": 32, **c}))
    assert 12.3e9 < nbytes < 12.5e9  # ~3.7 ms a step at 3.35 TB/s


# ------------------------------------------------------------------ readers

class Obs:
    def __init__(self, summary=None, epochs=None, profiled=None):
        self.trace = summary
        self.epochs = epochs or []
        self.profiled = profiled or {}

    def counter(self, kind, name):
        return spec.load_module(kind, name)


def read(name, obs):
    return spec.load_module("metrics", name).read(obs)


# product kernels as the trace names them (``resize_ms.KERNELS``)
CUBLAS = ("void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_nn_align1>"
          "(cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_nn_align1::Params)")
NVJET = "nvjet_tst_256x120_64x4_2x1_v_bz_coopA_NNT"
MAGMA = ("void magma_sgemmEx_kernel<float, __nv_bfloat16, __nv_bfloat16, false, true, 6, 4, 6, "
         "3, 4>(int, int, int, Tensor, int, Tensor, int, Tensor, int, Tensor, int, int, int, "
         "float const*, float const*, float, float, int, cublasLtEpilogue_t, int, void const*, "
         "long)")
# convolutions: cuDNN's own kernels, and the GEMM kernels it runs some on
CUDNN = ["sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x64x64",
         "void cutlass__5x_cudnn::Kernel_cutlass_tensorop_bf16_s16816fprop_optimized",
         "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
         "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x256",
         "nvjet_tst_128x144_64x6_2x1_v_bz_NNT",
         "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_128x64_64x3_nt_"
         "align8>(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_128x64_64x3_nt_align8::Params)",
         "void cutlass::Kernel2<cutlass_80_simt_sgemm_32x128_8x5_tn_align1>"
         "(cutlass_80_simt_sgemm_32x128_8x5_tn_align1::Params)"]


def summary():
    # two train steps in [0, 4]: a CUTLASS product (0.5 s), an nvjet product
    # (0.25 s), a kernel named for a resize (0.25 s), convolutions, FDS and
    # Adam; the stats pass [4, 6] also runs a product, not counted
    events = [(CUBLAS, 0.0, 0.5), (NVJET, 0.5, 0.75),
              ("bilinear_resize_backward_kernel", 0.75, 1.0)]
    events += [(name, 1.0 + 0.2 * i, 1.1 + 0.2 * i) for i, name in enumerate(CUDNN)]
    events += [("calibrate_gather_kernel", 2.0, 2.5), ("multi_tensor_apply_kernel_fused_adam",
                                                        2.5, 3.0), (CUBLAS, 4.5, 5.0)]
    merged = trace.merge((s, e) for _, s, e in events)
    return trace.TraceSummary(0.0, 6.0, events, merged,
                              [("train_epoch", 0.0, 4.0), ("fds_pass", 4.0, 6.0)])


def resize_calls(least_s):
    """Resize calls of the depth model whose products' least time is
    ``least_s`` seconds (a batch scaled to it), and a K1 call."""
    counter = spec.load_module("bytes", "resize")
    call = {"kernel": "resize", "n": 1, "c": 2048, "h": 8, "w": 10, "H": 114, "W": 152}
    n = least_s / (counter.least_seconds(call) + counter.least_seconds(dict(call, c=1024)))
    return [dict(call, n=n), dict(call, c=1024, n=n), {"kernel": "calibrate"}]


def test_resize_reader_counts_products_and_not_convolutions():
    is_resize = spec.load_module("metrics", "resize_ms").is_resize
    assert is_resize(CUBLAS) and is_resize(NVJET) and is_resize(MAGMA)
    assert is_resize("any_resize_kernel") and not is_resize(NVJET + "_x")
    for name in CUDNN:
        assert not is_resize(name), name
    obs = Obs(summary(), profiled={"steps": 2, "kernel_calls": resize_calls(0.4)})
    assert read("resize_ms", obs) == pytest.approx(1e3 * 1.0 / 2)


def test_resize_roofline_is_least_time_over_traced_time():
    counter = spec.load_module("bytes", "resize")
    calls = resize_calls(0.4)
    obs = Obs(summary(), profiled={"steps": 2, "kernel_calls": calls})
    least = counter.least_seconds(calls[0]) + counter.least_seconds(calls[1])
    assert least == pytest.approx(0.4, rel=1e-3)
    assert read("resize_roofline", obs) == pytest.approx(100.0 * least / 1.0)
    assert read("resize_roofline", Obs(summary(), profiled={"steps": 2})) is None
    assert read("resize_ms", Obs(None, profiled={"steps": 2})) is None


@pytest.mark.parametrize("least_s", [1.5, 0.1, None])
def test_resize_readers_read_nothing_outside_their_band(least_s):
    """A traced time under the products' least time (names missed), over
    six times it (other kernels taken), or no products counted: neither
    reader reads."""
    calls = resize_calls(least_s) if least_s else [{"kernel": "calibrate"}]
    obs = Obs(summary(), profiled={"steps": 2, "kernel_calls": calls})
    assert read("resize_ms", obs) is None and read("resize_roofline", obs) is None


def test_test_pass_ms_is_the_mean_unprofiled_pass():
    epochs = [{"profiled": False, "phases": {"test": t}} for t in (0.2, 0.4)]
    epochs.append({"profiled": True, "phases": {"test": 9.0}})
    assert read("test_pass_ms", Obs(epochs=epochs)) == pytest.approx(300.0)
    assert read("test_pass_ms", Obs(epochs=epochs[2:])) == pytest.approx(9000.0)
    assert read("test_pass_ms", Obs(epochs=[{"profiled": False, "phases": {}}])) is None


@pytest.fixture
def spans(monkeypatch):
    rec = SpanRecorder()
    rec.newest = 4
    monkeypatch.setattr(logging_tools, "recorder", rec)
    return rec


def add(rec, name, epoch, start_s, ms, trainer=4):
    s = Span(rec, name, trainer, epoch, -1)
    s.start_ns = 10 ** 18 + round(start_s * 1e9)
    s.end_ns = s.start_ns + round(ms * 1e6)
    s.thread, s.parent, s.interval_ms = 0, None, None
    rec.records.append(s)


def test_test_host_ms_sums_a_pass_over_the_window_epochs(spans):
    epochs = [{"epoch": e, "profiled": e == 5, "phases": {}} for e in (2, 3, 4, 5)]
    add(spans, "upsample", 2, 0.0, 50.0)  # the first epoch: left out
    for epoch, ms in ((3, (1.0, 2.0, 3.0)), (4, (4.0, 6.0))):
        for i, m in enumerate(ms):
            add(spans, "upsample" if i % 2 else "shot_metrics", epoch, epoch + i, m)
    add(spans, "test", 3, 3.0, 100.0)  # the pass itself: not host work of its own
    add(spans, "shot_metrics", 5, 9.0, 70.0)  # the profiled epoch
    add(spans, "upsample", 3, 3.5, 80.0, trainer=3)  # another trainer's
    assert read("test_host_ms", Obs(epochs=epochs)) == pytest.approx((6.0 + 10.0) / 2)
    assert read("test_host_ms", Obs(epochs=epochs[:1] + epochs[3:])) is None


def test_test_host_ms_reads_nothing_without_the_recorder(monkeypatch):
    bare = types.ModuleType(logging_tools.__name__)
    monkeypatch.setitem(sys.modules, logging_tools.__name__, bare)
    assert read("test_host_ms", Obs(epochs=[{"epoch": 3, "profiled": False}] * 2)) is None


def test_readers_of_a_parent_without_test_spans(spans):
    """The parent commit's program opens no ``upsample`` or ``shot_metrics``
    span: the reader reads nothing and raises nothing."""
    epochs = [{"epoch": e, "profiled": e == 4, "phases": {}} for e in (2, 3, 4)]
    add(spans, "step", 3, 0.0, 5.0)
    assert read("test_host_ms", Obs(epochs=epochs)) is None
