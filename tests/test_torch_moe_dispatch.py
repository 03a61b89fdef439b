"""The DeepSeekMoE layer's token dispatch and combine
(``ops/moe_dispatch.py``, ``csrc/moe_dispatch.cu``) and the
``deepseek_v2`` encoder's graphed step.

On the CPU: the plain versions against a naive loop over tokens and slots
(the sorted rows, each slot's row, the offsets, the counters, the combine
and both backwards, exactly: the same float32 operations in the same
order, except the weights' gradient, a dot product summed in another
order, within 1e-6 of the largest); ``torch.autograd.gradcheck`` of
``MoEDispatch`` and ``MoECombine`` in float64; the wrappers running the
plain versions for CPU tensors; the encoder's steps taken through the
graphed path (a stand-in graph that replays by running the update again)
equal to eager ones.

On the card (marked ``cuda``): the kernels against the plain versions run
on the card, at the STS-B cell's shape (10,240 tokens, top-6 of 64, 8 held,
D = 2,048, bf16) and at a ragged float32 one (one value a thread), forward
and backward: rows, slots, offsets and counters equal, the combine and
both backwards bit for bit (unfused products and sums in slot order on
both sides), the weights' gradient within 1e-5 of the largest; the launch
counts; a ``deepseek_v2`` encoder's six graphed steps across a stats
pass bit-equal to six eager ones; and the kernels the held experts'
products launch in an eager step at DeepSeek-V2-Lite's widths being those
the benchmark's ``expert_gemm_roofline`` takes by name, and no others.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_moe_dispatch.py -q
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.models import deepseek_v2 as dsv2
from imbalanced_regression_tpu_torch.models.resnet import RegressionHead
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.ops import moe_dispatch as md
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig
from test_torch_graphed_step import (  # noqa: F401  (fixtures)
    _few_threads,
    assert_outputs_equal,
    assert_states_equal,
    bilstm_data,
    cuda_device,
    deterministic,
    eager,
    fake_graphs,
    run_across_a_stats_pass,
)


def _routing(tokens, k, experts, seed=0, device="cpu"):
    """The router's top-k experts [T, K] int64 and weights [T, K] float32
    of random logits."""
    gen = torch.Generator().manual_seed(seed)
    probs = torch.randn(tokens, experts, generator=gen).softmax(-1)
    w, idx = probs.topk(k, dim=-1)
    return w.to(device), idx.to(device)


def _naive(x, idx, w, lo, held):
    """(rows, pos, offs, out) by loops: the held slots' tokens in expert
    order, slot order within an expert; each token's weighted sum of its
    held rows' x in slot order."""
    tokens, k = idx.shape
    pos = -np.ones((tokens, k), np.int64)
    rows, offs = [], []
    for e in range(held):
        for t in range(tokens):
            for j in range(k):
                if int(idx[t, j]) - lo == e:
                    pos[t, j] = len(rows)
                    rows.append(t)
        offs.append(len(rows))
    out = torch.zeros(tokens, x.shape[1], dtype=torch.float32)
    for t in range(tokens):
        for j in range(k):
            if pos[t, j] >= 0:
                out[t] = out[t] + w[t, j] * x[t].float()
    return rows, pos, offs, out


@pytest.mark.parametrize("tokens,k,experts,held,lo", [(40, 3, 8, 2, 2), (33, 6, 64, 8, 0),
                                                      (17, 2, 4, 4, 0), (9, 3, 8, 1, 7)])
def test_plain_dispatch_and_combine_match_a_loop(tokens, k, experts, held, lo):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(tokens, 12, generator=gen)
    w, idx = _routing(tokens, k, experts, seed=tokens)
    rows_n, touched = torch.zeros(held, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)
    xs, pos, offs = md.moe_dispatch_plain(x, idx, lo, held, rows_n, touched)
    rows, want_pos, want_offs, want_out = _naive(x, idx, w, lo, held)
    assert xs.shape == (tokens * min(k, held), 12) and pos.dtype == offs.dtype == torch.int32
    assert pos.tolist() == want_pos.tolist() and offs.tolist() == want_offs
    assert torch.equal(xs[:len(rows)], x[rows]) and not xs[len(rows):].any()
    per = np.diff([0] + want_offs)
    assert rows_n.tolist() == per.tolist()
    assert touched.item() == int((want_pos >= 0).any(1).sum())
    # the products: y = 2 * xs, so out is 2 * the weighted sum of x
    out = md.moe_combine_plain(2.0 * xs, w, pos)
    torch.testing.assert_close(out, 2.0 * want_out, rtol=0, atol=0)
    # backward: the dispatch's sums a token's held rows; the combine's is
    # one row a slot and the weights' dot products
    dxs = torch.randn(xs.shape, generator=gen)
    dx = md.moe_dispatch_backward_plain(dxs, pos)
    want_dx = torch.zeros_like(x)
    for t in range(tokens):
        for j in range(k):
            if want_pos[t, j] >= 0:
                want_dx[t] = want_dx[t] + dxs[want_pos[t, j]]
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
    dout = torch.randn(tokens, 12, generator=gen)
    dy, dw = md.moe_combine_backward_plain(dout, xs, w, pos)
    for t in range(tokens):
        for j in range(k):
            p = want_pos[t, j]
            if p >= 0:
                assert torch.equal(dy[p], w[t, j] * dout[t])
                assert abs(float(dw[t, j] - dout[t] @ xs[p])) <= 1e-6 * float(dw.abs().max())
            else:
                assert dw[t, j] == 0
    assert not dy[len(rows):].any()


def test_autograd_functions_gradcheck_in_float64():
    torch.manual_seed(0)
    tokens, k, held, lo = 11, 3, 3, 2
    w, idx = _routing(tokens, k, 8, seed=5)
    x = torch.randn(tokens, 5, dtype=torch.float64, requires_grad=True)
    counters = (torch.zeros(held, dtype=torch.int64), torch.zeros(1, dtype=torch.int64))
    xs_only = lambda x: dsv2.MoEDispatch.apply(x, idx, lo, held, *counters)[0]  # noqa: E731
    assert torch.autograd.gradcheck(xs_only, (x,))
    _, pos, _ = md.moe_dispatch_plain(x.detach(), idx, lo, held, *counters)
    y = torch.randn(tokens * min(k, held), 5, dtype=torch.float64, requires_grad=True)
    w64 = w.double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda y, w: dsv2.MoECombine.apply(y, w, pos), (y, w64))


def test_wrappers_run_the_plain_versions_on_the_cpu():
    ck.reset_launch_counts()
    w, idx = _routing(20, 3, 8)
    x = torch.randn(20, 8)
    counters = (torch.zeros(2, dtype=torch.int64), torch.zeros(1, dtype=torch.int64))
    xs, pos, offs = ck.moe_dispatch(x, idx, 4, 2, *counters)
    want = md.moe_dispatch_plain(x, idx, 4, 2, torch.zeros(2, dtype=torch.int64),
                                 torch.zeros(1, dtype=torch.int64))
    assert all(torch.equal(a, b) for a, b in zip((xs, pos, offs), want))
    assert torch.equal(ck.moe_combine(xs, w, pos), md.moe_combine_plain(xs, w, pos))
    assert torch.equal(ck.moe_dispatch_backward(xs, pos), md.moe_dispatch_backward_plain(xs, pos))
    got, plain = ck.moe_combine_backward(x, xs, w, pos), md.moe_combine_backward_plain(x, xs, w, pos)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert [fn.launches for fn in (ck.moe_dispatch, ck.moe_dispatch_backward, ck.moe_combine,
                                   ck.moe_combine_backward)] == [0, 0, 0, 0]


TINY = dsv2.DeepSeekV2Config(
    vocab_size=60, hidden_size=64, num_hidden_layers=3, intermediate_size=96,
    moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=3,
    experts_held=2, expert_rank=1, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=16, v_head_dim=16)


def moe_trainer(device, dtype=torch.bfloat16):
    """The tiny DeepSeek-V2 pair encoder with the STS-B recipe's Adam, clip
    and FDS on the pair feature."""
    encoder = dsv2.PairMoEEncoder(TINY, dtype=dtype)
    return Trainer(encoder, RegressionHead(encoder.out_features),
                   TrainerConfig(loss="mse", lr=1e-3, clip_grad_norm=5.0, target_scale=5.0,
                                 schedule=()),
                   fds_config=FDSConfig.for_sts(feature_dim=encoder.out_features, bucket_num=50,
                                                start_smooth=1),
                   device=device)


def test_graphed_steps_equal_eager_on_the_cpu(fake_graphs, monkeypatch):
    """Six steps across a stats pass through the graphed path (the stand-in
    graph replays the captured update) against six eager steps, and the
    routing counters counting the replays as the eager forwards."""
    data = bilstm_data()
    graphed = moe_trainer("cpu", torch.float32)
    got_state, got = run_across_a_stats_pass(graphed, data, indexed=True)
    assert graphed.graph_stats["step"] == {"captures": 1, "replays": 5, "eager": 1}
    eager(monkeypatch)
    plain = moe_trainer("cpu", torch.float32)
    want_state, want = run_across_a_stats_pass(plain, data, indexed=True)
    assert_outputs_equal(got, want)
    assert_states_equal(got_state, want_state)
    for name in ("routed_rows", "routed_tokens"):
        g, w = getattr(got_state.backbone, name), getattr(want_state.backbone, name)
        assert torch.equal(g, w) and w.sum() > 0, name


# ----------------------------------------------------------- card tests
def _card_case(dev, tokens, k, experts, held, lo, d, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w, idx = _routing(tokens, k, experts, seed=seed, device=dev)
    x = torch.randn(tokens, d, generator=gen, device=dev).to(dtype)
    return gen, w, idx, x


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,k,experts,held,lo,d,dtype", [
    (10240, 6, 64, 8, 0, 2048, torch.bfloat16),  # the STS-B cell's layer
    (10240, 6, 64, 8, 56, 2048, torch.float32),
    (37, 3, 8, 3, 2, 37, torch.float32),  # one value a thread
    (300, 2, 4, 4, 0, 40, torch.bfloat16)])
def test_kernels_match_the_plain_versions_on_card(cuda_device, tokens, k, experts, held, lo, d,
                                                  dtype):
    gen, w, idx, x = _card_case(cuda_device, tokens, k, experts, held, lo, d, dtype, tokens + d)
    counters = [torch.zeros(held, dtype=torch.int64, device=cuda_device),
                torch.zeros(1, dtype=torch.int64, device=cuda_device)]
    plain_counters = [c.clone() for c in counters]
    ck.reset_launch_counts()
    xs, pos, offs = ck.moe_dispatch(x, idx, lo, held, *counters)
    pxs, ppos, poffs = md.moe_dispatch_plain(x, idx, lo, held, *plain_counters)
    torch.cuda.synchronize()
    total = int(poffs[-1])
    assert torch.equal(pos, ppos) and torch.equal(offs, poffs)
    assert all(torch.equal(a, b) for a, b in zip(counters, plain_counters))
    assert torch.equal(xs[:total], pxs[:total])
    y = (torch.randn(xs.shape, generator=gen, device=cuda_device)).to(dtype)
    assert torch.equal(ck.moe_combine(y, w, pos), md.moe_combine_plain(y, w, pos))
    assert torch.equal(ck.moe_dispatch_backward(y, pos), md.moe_dispatch_backward_plain(y, pos))
    dout = torch.randn(tokens, d, generator=gen, device=cuda_device)
    dy, dw = ck.moe_combine_backward(dout, y, w, pos)
    pdy, pdw = md.moe_combine_backward_plain(dout, y, w, pos)
    torch.cuda.synchronize()
    assert torch.equal(dy[:total], pdy[:total])
    assert float((dw - pdw).abs().max()) <= 1e-5 * float(pdw.abs().max())
    assert [fn.launches for fn in (ck.moe_dispatch, ck.moe_dispatch_backward, ck.moe_combine,
                                   ck.moe_combine_backward)] == [2, 1, 1, 1]


@pytest.mark.cuda
def test_graphed_steps_bit_equal_to_eager_on_card(cuda_device, deterministic, monkeypatch):
    """Six steps across a stats pass, captured and replayed, against six
    eager steps of the bf16 ``deepseek_v2`` encoder (grouped products,
    the dispatch kernels, attention): losses, predictions, parameters,
    Adam's state, FDS state and the routing counters bit for bit, and the
    kernels' launches counted alike."""
    data = bilstm_data()
    ck.reset_launch_counts()
    graphed = moe_trainer(cuda_device)
    got_state, got = run_across_a_stats_pass(graphed, data, indexed=True)
    torch.cuda.synchronize()
    got_launches = [fn.launches for fn in ck.KERNEL_WRAPPERS]
    assert graphed.graph_stats["step"] == {"captures": 1, "replays": 5, "eager": 1}
    assert graphed.graph_stats["pass"]["replays"] > 0
    eager(monkeypatch)
    ck.reset_launch_counts()
    plain = moe_trainer(cuda_device)
    want_state, want = run_across_a_stats_pass(plain, data, indexed=True)
    torch.cuda.synchronize()
    assert got_launches == [fn.launches for fn in ck.KERNEL_WRAPPERS]
    assert ck.moe_combine_backward.launches == 6 * (TINY.num_hidden_layers - 1)
    assert_outputs_equal(got, want)
    assert_states_equal(got_state, want_state)
    for name in ("routed_rows", "routed_tokens"):
        assert torch.equal(getattr(got_state.backbone, name), getattr(want_state.backbone, name))


def _is_expert_gemm():
    """The benchmark's name test of the grouped-product kernels
    (``benchmark/metrics/expert_gemm_roofline.py``, which imports nothing)."""
    path = Path(__file__).resolve().parents[1] / "benchmark" / "metrics" / "expert_gemm_roofline.py"
    spec = importlib.util.spec_from_file_location("expert_gemm_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.is_expert_gemm


def _launched(prof):
    """(kernel name, names of the host events above its launch) of each
    kernel a ``torch.profiler`` window traced."""
    def above(event):
        while event is not None:
            yield event.name
            event = event.cpu_parent

    pairs = [(e, e.kernels) for e in prof.events() if getattr(e, "kernels", None)]
    if not pairs:  # kernels listed as device events of their own
        pairs = [(e.cpu_parent, [e]) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    return [(k.name, list(above(e))) for e, kernels in pairs for k in kernels]


@pytest.mark.cuda
def test_expert_gemm_reader_takes_the_grouped_products_on_card(cuda_device, monkeypatch):
    """One eager train step of the bf16 encoder at DeepSeek-V2-Lite's
    widths (two layers, one MoE layer, 8 experts held, 16 pairs of 12
    tokens), traced: the kernels launched inside a profiler range around
    each ``grouped_mm`` (the products forward) or under autograd's
    ``GroupedMmBackward`` nodes are all kernels ``expert_gemm_roofline``
    takes, and the step launches no such kernel elsewhere (the dense
    products, attention and the dispatch kernels stay out)."""
    eager(monkeypatch)
    grouped_mm = dsv2.grouped_mm

    def ranged(x, w, offs):
        with torch.profiler.record_function("expert_gemm"):
            return grouped_mm(x, w, offs)

    monkeypatch.setattr(dsv2, "grouped_mm", ranged)
    config = dsv2.DeepSeekV2Config(vocab_size=64, num_hidden_layers=2, experts_held=8)
    encoder = dsv2.PairMoEEncoder(config, dtype=torch.bfloat16)
    trainer = Trainer(encoder, RegressionHead(encoder.out_features),
                      TrainerConfig(loss="mse", lr=1e-4, clip_grad_norm=5.0, target_scale=5.0,
                                    schedule=()), device=cuda_device)
    state = trainer.init_state(0)
    data = bilstm_data(n=16)
    batch = {k: data[k] for k in ("input", "target", "weight")}
    state, _, _ = trainer.train_step(state, batch, 0)  # warm-up
    torch.cuda.synchronize()
    kinds = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=kinds) as prof:
        trainer.train_step(state, batch, 0)
        torch.cuda.synchronize()
    launched = _launched(prof)
    products = {name for name, above in launched
                if "expert_gemm" in above or any("GroupedMmBackward" in n for n in above)}
    taken = {name for name, _ in launched if _is_expert_gemm()(name)}
    assert any("GroupProblemShape" in n for n in products), sorted(products)
    assert products == taken, (sorted(products - taken), sorted(taken - products))
