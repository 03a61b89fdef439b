"""The DeepSeek-V2 cell (``stsb-dsv2lite.b128``) at a small size on the
CPU: whole runs, untraced and traced (the result line's keys, ``correct``),
``correct`` false under the control and each planted fault that reaches
the indexed STS-B path (one of them confined to the held experts'
gradients); the configuration against the published
``config.json`` keys; its counters against hand counts; and its two
readers (``moe_dispatch_roofline``, ``expert_gemm_roofline``) on hand-made
traces, reading nothing where their kernels are absent."""

import json

import pytest
import torch

import readings
from dirbench import peaks, runner, spec, trace
from tiny import SEED

CELL = "stsb-dsv2lite.b128"
# hidden 64, 4 heads, rope 16, latent 32, 8 experts of width 32 with 2
# held, top-3, 3 layers (1 dense), 12 tokens, batch 8: 15 steps and a
# 15-batch stats pass an epoch
TINY = {"hidden_size": 64, "num_attention_heads": 4, "qk_rope_head_dim": 16,
        "qk_nope_head_dim": 16, "v_head_dim": 16, "kv_lora_rank": 32, "intermediate_size": 96,
        "moe_intermediate_size": 32, "n_routed_experts": 8, "experts_held": 2,
        "num_experts_per_tok": 3, "num_hidden_layers": 3, "vocab_size": 304,
        "data": {"train": 120, "corpus": {"words": 300}}, "recipe": {"max_seq_len": 12},
        "batch_size": 8, "setup_pass_batches": 1}
# the faults of readings.py that reach this cell's path (no staging ring,
# no validation), and one confined to the held experts
PLANTED = ("half_batch", "unchanged", "stats_unchanged", "expert_grad")


def expert_grad(trainer, state) -> None:
    """Fault: the held experts' weight gradients halved, every other leaf
    sound (as a grouped product's backward that lost half of its sum would
    leave them; Adam's update barely moves, the median leaf not at all)."""
    for name, p in state.backbone.named_parameters():
        if ".mlp.experts_" in name:
            p.register_hook(lambda g: 0.5 * g)


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(traced=False, seconds=0.01):
    result, rows = runner.run_cell(CELL, SEED, seconds, traced, device="cpu", overrides=TINY)
    return json.loads(json.dumps(result)), rows


@pytest.mark.parametrize("traced", [False, True])
def test_whole_run(traced):
    line, _ = run(traced, seconds=1.5 if traced else 0.01)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % 120 == 0 and line["attempted"] > 0
    assert [r[0] for r in line["checked"]] == list(spec.load_json("limits", CELL))
    if traced:
        # the CPU traces no device: the trace's readers read nothing, the
        # host clock's do
        metrics = line["metrics"]
        assert "moe_dispatch_roofline" not in metrics and "expert_gemm_roofline" not in metrics
        assert metrics["fds_pass_ms"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}


@pytest.mark.parametrize("kind", ["control", *PLANTED])
def test_control_and_faults_are_not_correct(kind, monkeypatch):
    monkeypatch.setitem(readings.FAULTS, "expert_grad", expert_grad)
    numbers = readings.reading(CELL, SEED, kind, "cpu", TINY)["numbers"]
    sound = readings.reading(CELL, SEED, "sound", "cpu", TINY)["numbers"]
    limits = spec.load_json("limits", CELL)
    # at this size bf16 on the CPU is the program's own rounding; what is
    # held is that each fault moves a limited number well past the sound
    # program's reading, and past its limit
    assert any(numbers[k] > limits[k] and numbers[k] > 3 * sound[k] for k in limits), numbers


def test_configuration_keeps_the_published_keys():
    """Every number of DeepSeek-V2-Lite's ``config.json`` (the catalog's
    copy) at the top level, the cut ones listed in ``reduced``."""
    config = spec.load_json("configs", "stsb-dsv2lite")
    published = {"first_k_dense_replace": 1, "hidden_size": 2048, "intermediate_size": 10944,
                 "kv_lora_rank": 512, "max_position_embeddings": 163840,
                 "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
                 "n_routed_experts": 64, "n_shared_experts": 2, "num_attention_heads": 16,
                 "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
                 "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
                 "rope_theta": 10000, "routed_scaling_factor": 1, "topk_group": 1,
                 "v_head_dim": 128, "vocab_size": 102400}
    changed = {k for k, v in published.items() if config[k] != v}
    assert changed == {"num_hidden_layers"} and config["num_hidden_layers"] == 14
    assert config["reduced"] == ["num_hidden_layers", "experts_held"]
    assert config["published"] == {"num_hidden_layers": 27, "experts_held": 64}
    assert config["experts_held"] == 8 and config["expert_rank"] == 0
    assert config["rope_scaling"] == {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                                      "mscale": 0.707, "mscale_all_dim": 0.707,
                                      "original_max_position_embeddings": 4096, "type": "yarn"}


def _model():
    config = spec.load_json("configs", "stsb-dsv2lite")
    return {k: config[k] for k in config if not isinstance(config[k], (dict, list, str))}


def test_flops_hand_count():
    counter = spec.load_module("flops", "moe_pair")
    m = _model()
    token, seen = counter.per_token(m)
    attn = 2 * 2048 * 16 * 192 + 2 * 2048 * 576 + 2 * 512 * 16 * 256 + 2 * 16 * 128 * 2048
    moe = 2 * 2048 * 64 + 6 * 2048 * 2816 + 6 * 8 / 64 * 6 * 2048 * 1408
    assert token == pytest.approx(14 * attn + 6 * 2048 * 10944 + 13 * moe)
    assert seen == 14 * 2 * 16 * (192 + 128)
    # two sentences of 3 and 1 tokens: 4 tokens, 6 + 1 positions seen, one pair
    assert counter.forward_flops(m, [3, 1]) == pytest.approx(4 * token + 7 * seen + 2 * 4 * 2048)


def test_dispatch_bytes_and_expert_work_hand_count():
    counter = spec.load_module("bytes", "moe_dispatch")
    call = {"kernel": "moe_dispatch", "calls": 1, "tokens": 10, "rows": 4, "touched": 3, "d": 8,
            "k": 6, "held": 2, "width": 5, "elt": 2, "backward": False}
    fwd = (60 * 12 + 2 * 4) + ((3 + 4) * 16 + 60 * 4) + (4 * 16 + 60 * 8 + 10 * 32)
    assert counter.dispatch_bytes(call) == fwd
    bwd = dict(call, backward=True)
    assert counter.dispatch_bytes(bwd) == fwd + (10 * 32 + 2 * 4 * 16 + 60 * 12) \
        + (4 * 16 + 60 * 4 + 10 * 16)
    nbytes, flops = counter.expert_work(dict(bwd, kernel="expert_gemm"))
    assert flops == 3 * 6 * 8 * 5 * 4
    assert nbytes == 3 * (2 * 3 * 8 * 5 * 2 + 4 * (8 + 15 + 8) * 2)
    assert counter.least_seconds(dict(bwd, kernel="expert_gemm")) == peaks.least_seconds(
        nbytes, 0.0, flops)


GROUPED = ("void cutlass::device_kernel<at::cuda::detail::enable_3x_kernel_for_sm9x<cutlass::gemm::"
           "kernel::GemmUniversal<cutlass::gemm::GroupProblemShape<cute::tuple<int, int, int> >>>")
DENSE = "nvjet_tst_192x32_64x7_2x1_v_bz_NTT"
ROUTE = "(anonymous namespace)::moe_route_kernel(long const*, int, int)"
GATHER = "void (anonymous namespace)::moe_gather_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*)"


class Obs:
    def __init__(self, events, calls):
        events = sorted(events, key=lambda e: e[1])
        merged = trace.merge((s, e) for _, s, e in events)
        self.trace = trace.TraceSummary(0.0, 10.0, events, merged, [("train_steps", 0.0, 10.0)])
        self.profiled = {"steps": 2, "model_flops": 1.0, "kernel_calls": calls}
        self.epochs = [{"profiled": True, "phases": {}}]

    def counter(self, kind, name):
        return spec.load_module(kind, name)


CALL = {"calls": 41, "tokens": 41 * 10240, "rows": 41 * 7680, "touched": 41 * 6000, "d": 2048,
        "k": 6, "held": 8, "width": 1408, "elt": 2, "backward": True}


def _least(kind):
    return spec.load_module("bytes", "moe_dispatch").least_seconds(dict(CALL, kernel=kind))


def read(metric, obs):
    return spec.load_module("metrics", metric).read(obs)


def test_dispatch_roofline_is_least_time_over_its_kernels():
    least = _least("moe_dispatch")
    obs = Obs([(ROUTE, 1.0, 1.0 + least), (GATHER, 2.0, 2.0 + least), (DENSE, 3.0, 4.0)],
              [dict(CALL, kernel="moe_dispatch"), dict(CALL, kernel="expert_gemm")])
    assert read("moe_dispatch_roofline", obs) == pytest.approx(50.0)


def test_expert_gemm_roofline_takes_the_grouped_kernels_within_its_band():
    least = _least("expert_gemm")
    calls = [dict(CALL, kernel="expert_gemm")]
    obs = Obs([(GROUPED, 1.0, 1.0 + 2 * least), (DENSE, 5.0, 6.0)], calls)
    assert read("expert_gemm_roofline", obs) == pytest.approx(50.0)
    band = spec.load_module("metrics", "expert_gemm_roofline").BAND
    for ratio in (0.5, band[1] * 1.1):  # names missed, or others taken
        assert read("expert_gemm_roofline", Obs([(GROUPED, 1.0, 1.0 + ratio * least)], calls)) \
            is None


@pytest.mark.parametrize("metric", ["moe_dispatch_roofline", "expert_gemm_roofline"])
def test_readers_read_nothing_without_their_kernels_or_calls(metric):
    calls = [dict(CALL, kernel="moe_dispatch"), dict(CALL, kernel="expert_gemm")]
    # a program without the dispatch kernels or the grouped products
    assert read(metric, Obs([(DENSE, 1.0, 2.0)], calls)) is None
    # the kernels, but an epoch that counted no call
    assert read(metric, Obs([(ROUTE, 1.0, 1.1), (GROUPED, 2.0, 3.0)], [])) is None
    obs = Obs([], calls)
    obs.trace = None
    assert read(metric, obs) is None
