"""The port's DeepSeek-V2 STS-B encoder and ``Trainer`` against the
benchmark's plain float32 reference (``benchmark/reference/deepseek_v2.py``,
which imports nothing of the port), on one set of seeded weights drawn into
both sides, at a small size on the CPU (hidden 64, 4 heads, rope 16, latent
32, 8 routed experts of width 32 with 2 held, top-3, 3 layers of which 1
dense, 12 tokens, batch 4): the pair feature, the loss, every leaf's
gradient and one Adam step; the stats pass's FDS tables and a calibrated
step; the routing counters against the reference's choices; and the chip
share: one MoE layer's routed parts from all 4 shares of its experts, with
the shared experts counted once, add up to the uncut reference layer.

Tolerances: both sides compute in float32 (the port's model switched from
bf16 to float32, as the benchmark's ``float32`` witness does), in other
orders (attention through ``scaled_dot_product_attention`` against a
product a head, SwiGLU's two halves as one product, the experts' rows
sorted and summed in slot order against boolean selections and an
accumulating ``index_put``), so values agree to float32 round-off grown
through 3 layers. No routing choice is near a tie at these seeds: a flip
would move a token's output by a whole expert's share and fail every
tolerance below."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from dirbench.inputs import draw_weights  # noqa: E402
from imbalanced_regression_tpu_torch.models import deepseek_v2 as dsv2  # noqa: E402
from imbalanced_regression_tpu_torch.tasks import stsb  # noqa: E402
from reference import deepseek_v2 as rdsv2  # noqa: E402
from reference import fds as rfds  # noqa: E402
from reference import optim as roptim  # noqa: E402

BATCH, STEPS, VOCAB, SEED = 4, 12, 60, 2 ** 31 + 23
TINY = {"vocab_size": VOCAB, "hidden_size": 64, "num_hidden_layers": 3, "first_k_dense_replace": 1,
        "intermediate_size": 96, "moe_intermediate_size": 32, "n_routed_experts": 8,
        "n_shared_experts": 2, "num_experts_per_tok": 3, "experts_held": 2, "expert_rank": 1,
        "num_attention_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 16, "v_head_dim": 16, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "initializer_range": 0.02}
ROPE = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
        "original_max_position_embeddings": 4096, "type": "yarn"}
RECIPE = {"lr": 1e-4, "reweight": "inverse", "lds": True, "fds": True, "bucket_num": 50,
          "start_update": 0, "start_smooth": 1, "fds_mmt": 0.9, "max_grad_norm": 5.0}
# float32 round-off relative to each tensor's largest entry; each ~6-17x
# the largest gap seen (the feature, tables and shares' sum 7e-8-3.3e-7,
# gradients 7.3e-7-1.0e-6, the Adam step 5.7e-8), so a real difference of a
# term or a constant fails
RTOL_MAP = 2e-6
RTOL_GRAD = 1e-5
RTOL_STEP = 1e-6  # of the largest weight: a thousandth of an lr-sized move


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(**over):
    return {**TINY, "rope_scaling": ROPE, **over}


def _batch(seed):
    rng = np.random.default_rng(seed)

    def column():
        lengths = rng.integers(3, STEPS + 1, BATCH)
        mask = (np.arange(STEPS)[None] < lengths[:, None]).astype(np.float32)
        return rng.integers(4, VOCAB, (BATCH, STEPS)).astype(np.int32) * mask.astype(np.int32), mask

    (t1, m1), (t2, m2) = column(), column()
    scores = np.round(rng.uniform(0, 5, BATCH), 3).astype(np.float32)
    return {"input": {"tokens1": t1, "mask1": m1, "tokens2": t2, "mask2": m2},
            "target": scores[:, None], "bucket_idx": rfds.hist_bins(scores, 50).astype(np.int32),
            "weight": np.linspace(0.5, 1.5, BATCH, dtype=np.float32)[:, None]}


def _sides():
    """(trainer, state, reference model, reference FDS), both sides holding
    the same drawn weights."""
    enc0, head0 = draw_weights(list(rdsv2.layout(_cfg())), SEED, torch.device("cpu"))
    config = stsb.STSConfig(**TINY, **RECIPE, encoder="deepseek_v2", glove=0, device="cpu",
                            batch_size=BATCH)
    trainer = stsb.build_sts_trainer(config, VOCAB, None)
    state = trainer.init_state(SEED)
    for m in state.backbone.modules():  # float32, as the benchmark's witness
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32
    state.backbone.load_state_dict(enc0)
    state.head.load_state_dict(head0)
    enc = {k: v.clone() for k, v in enc0.items()}
    head = {k: v.clone() for k, v in head0.items()}
    model = rdsv2.PairRegressor(enc, head, _cfg())
    fds = rfds.FDS(rfds.FDSConfig(
        feature_dim=4 * TINY["hidden_size"], bucket_num=50, bucket_start=0, start_update=0,
        start_smooth=1, ks=5, sigma=2.0, momentum=0.9, grouping="hist", clip_min=0.5,
        clip_max=2.0, guard="positive"), "cpu")
    return trainer, state, model, fds


def _close(got, want, rtol, what):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    scale = want.abs().max().item()
    gap = (got - want).abs().max().item()
    assert gap <= rtol * max(scale, 1e-30), f"{what}: gap {gap:.3g} at scale {scale:.3g}"


def _tokens(batch):
    return {k: torch.from_numpy(v) for k, v in batch["input"].items()}


def _leaves(model):
    return {**{f"backbone.{k}": v for k, v in model.enc.items() if rdsv2.trained(model.cfg, k)},
            **{f"head.{k}": v for k, v in model.head.items()}}


def _ref_step(model, fds, batch, epoch, adam=None):
    """The reference's step: (loss, clipped gradients by leaf, leaves), and
    with ``adam`` its update."""
    leaves = _leaves(model)
    for v in leaves.values():
        v.requires_grad_(True)
    feat = fds.smooth(model.encode(_tokens(batch)), torch.from_numpy(batch["bucket_idx"]).long(),
                      epoch)
    loss = roptim.weighted_mse(model.predict(feat), torch.from_numpy(batch["target"]) / 5.0,
                               torch.from_numpy(batch["weight"]))
    grads = roptim.clip_global_norm(list(torch.autograd.grad(loss, list(leaves.values()))),
                                    RECIPE["max_grad_norm"])
    grads = dict(zip(leaves, grads))
    if adam is not None:
        adam.step(leaves, grads)
    return loss.item(), grads, leaves


def _port_leaves(state):
    return {**{f"backbone.{n}": p for n, p in state.backbone.named_parameters()
               if p.requires_grad},
            **{f"head.{n}": p for n, p in state.head.named_parameters()}}


def test_rope_tables_and_scale_match_the_reference():
    cos, sin = dsv2.rope_tables(STEPS, 64, 10000.0, "cpu")
    rcos, rsin = rdsv2.rope_cos_sin(_cfg(qk_rope_head_dim=64), STEPS, "cpu")
    torch.testing.assert_close(cos, rcos, rtol=0, atol=1e-6)
    torch.testing.assert_close(sin, rsin, rtol=0, atol=1e-6)
    # the published softmax scale: mscale(40, 0.707)^2 / sqrt(192)
    assert math.isclose(dsv2.attention_scale(dsv2.DeepSeekV2Config()), 0.114721, rel_tol=1e-5)


def test_pair_feature_loss_gradients_and_one_adam_step():
    trainer, state, model, fds = _sides()
    batch = _batch(1)
    state.backbone.train()
    with torch.no_grad():
        _close(state.backbone(_tokens(batch)), model.encode(_tokens(batch)), RTOL_MAP,
               "pair feature")
    state, loss, _ = trainer.train_step(state, batch, 0)  # no calibration before epoch 1
    adam = roptim.Adam(_leaves(model), lr=RECIPE["lr"])
    ref_loss, grads, leaves = _ref_step(model, fds, batch, 0, adam)
    assert math.isclose(loss.item(), ref_loss, rel_tol=RTOL_MAP)
    port = _port_leaves(state)
    assert set(port) == set(grads)
    for name, g in grads.items():
        _close(port[name].grad, g, RTOL_GRAD, f"gradient of {name}")
    # 2 of 8 experts held: the MoE layers' routers neither train nor move
    routers = [layer.mlp.gate.weight for layer in state.backbone.layers[1:]]
    assert all(w.grad is None and not w.requires_grad for w in routers)
    assert all(torch.equal(w, model.enc[f"layers.{i}.mlp.gate.weight"])
               for i, w in enumerate(routers, start=1))
    # the first Adam step moves each coordinate by lr * g / (|g| + eps'):
    # compare it where |g| is above round-off
    for name, p in port.items():
        g = grads[name]
        sure = g.abs() > 1e-3 * g.abs().max()
        _close(p.detach()[sure], leaves[name].detach()[sure], RTOL_STEP, f"step of {name}")


def test_stats_pass_tables_and_a_calibrated_step():
    trainer, state, model, fds = _sides()
    passes = [_batch(10 + i) for i in range(4)]
    for epoch in (0, 1):
        part = passes[2 * epoch:2 * epoch + 2]
        state = trainer.fds_epoch_pass(state, iter(part), epoch)
        with torch.no_grad():
            feats = [model.encode(_tokens(b)) for b in part]
        fds.update_last_epoch_stats(epoch)
        fds.update_running_stats(torch.cat(feats), torch.cat(
            [torch.from_numpy(b["bucket_idx"]).long() for b in part]), epoch)
    for name, ref in (("running_mean", fds.running_mean), ("running_var", fds.running_var),
                      ("running_mean_last_epoch", fds.mean_last),
                      ("smoothed_var_last_epoch", fds.smoothed_var)):
        _close(getattr(state.fds, name), ref, RTOL_MAP, name)
    batch = _batch(3)
    state, loss, _ = trainer.train_step(state, batch, 2)  # FDS calibrates the pair feature
    ref_loss, grads, _ = _ref_step(model, fds, batch, 2)
    assert math.isclose(loss.item(), ref_loss, rel_tol=RTOL_MAP)
    port = _port_leaves(state)
    for name, g in grads.items():
        _close(port[name].grad, g, RTOL_GRAD, f"calibrated gradient of {name}")


def test_routing_counters_match_the_reference_choices():
    """The encoder's device counters after one forward: each held expert's
    routed rows and the tokens with a held slot, as the reference's own
    top-3 choices count them layer by layer."""
    _, state, model, _ = _sides()
    batch = _batch(5)
    enc = state.backbone
    enc.reset_counters()
    with torch.no_grad():
        enc(_tokens(batch))
    chosen = []
    real_moe = model.moe

    def recording(x, p):
        logits = x @ model.enc[p + "gate.weight"].t()
        chosen.append(torch.softmax(logits, -1).topk(TINY["num_experts_per_tok"], -1).indices)
        return real_moe(x, p)

    model.moe = recording
    with torch.no_grad():
        model.encode(_tokens(batch))
    lo = TINY["expert_rank"] * TINY["experts_held"]
    want_rows = [[int((c == lo + e).sum()) for e in range(TINY["experts_held"])] for c in chosen]
    want_tokens = [int(((c >= lo) & (c < lo + TINY["experts_held"])).any(1).sum()) for c in chosen]
    assert enc.routed_rows.tolist() == want_rows and enc.routed_tokens.tolist() == want_tokens
    assert sum(map(sum, want_rows)) > 0


def test_chip_shares_add_up_to_the_uncut_layer():
    """One MoE layer in 4 shares of 2 experts (expert ranks 0-3): the sum of
    each share's routed part, with the shared experts counted once, equals
    the reference's layer holding all 8 experts."""
    cfg = _cfg(experts_held=8, expert_rank=0)
    enc0, _ = draw_weights(list(rdsv2.layout(cfg)), SEED + 1, torch.device("cpu"))
    p = "layers.1.mlp."
    uncut = {k[len(p):]: v for k, v in enc0.items() if k.startswith(p)}
    x = torch.randn(3 * STEPS, TINY["hidden_size"], generator=torch.Generator().manual_seed(9))
    ref = rdsv2.PairRegressor(enc0, {}, cfg).moe(x, p)
    shared, total = None, torch.zeros_like(x)
    for rank in range(4):
        layer = dsv2.MoELayer(dsv2.DeepSeekV2Config(**{**TINY, "expert_rank": rank}),
                              torch.float32)
        held = slice(2 * rank, 2 * rank + 2)
        layer.load_state_dict({**{k: v for k, v in uncut.items() if not k.startswith("experts_")},
                               "experts_gate_up": uncut["experts_gate_up"][held],
                               "experts_down": uncut["experts_down"][held]})
        counters = (torch.zeros(2, dtype=torch.int64), torch.zeros(1, dtype=torch.int64))
        with torch.no_grad():
            out = layer(x, *counters)
            shared = layer.shared_experts(x)
        total += out - shared
    _close(total + shared, ref, RTOL_MAP, "the shares' sum")
