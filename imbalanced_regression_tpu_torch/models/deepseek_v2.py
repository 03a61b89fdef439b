"""DeepSeek-V2-Lite as the STS-B-DIR sentence-pair encoder, with an
expert-parallel DeepSeekMoE layer.

:class:`PairMoEEncoder` has :class:`models.bilstm_pair.PairBiLSTMEncoder`'s
contract: a batch ``{"tokens1", "mask1", "tokens2", "mask2"}`` in, the pair
feature ``[s1; s2; |s1 - s2|; s1 * s2]`` [B, 4 * hidden] in float32 out,
so FDS calibrates it and :class:`models.resnet.RegressionHead` regresses
the score. Both sentence columns run as one doubled batch, right-padded to
the longer column.

The network is DeepSeek-V2's decoder (DeepSeek-AI, "DeepSeek-V2: A Strong,
Economical, and Efficient Mixture-of-Experts Language Model", 2024, and the
``modeling_deepseek.py`` published with the model), configured by
:class:`DeepSeekV2Config` (defaults: DeepSeek-V2-Lite's ``config.json``):

- a token embedding, then blocks of ``h += Attn(RMSNorm(h))``, ``h +=
  FFN(RMSNorm(h))``, a final RMSNorm, and a mean over each sentence's valid
  tokens (padding is on the right and attention is causal, so valid tokens
  never see it);
- attention is MLA without query compression (:class:`MLAttention`): ``q =
  W_q h`` per head ``qk_nope_head_dim + qk_rope_head_dim``; ``[c; k_pe] =
  W_kva h``; ``[k_nope; v] = W_kvb RMSNorm(c)``; ``q_pe`` and the one
  ``k_pe`` all heads share are de-interleaved (32 pairs, transposed) and
  rotated with YaRN frequencies (:func:`yarn_inv_freq`); scores ``(q_nope .
  k_nope + q_pe . k_pe) * s`` with ``s = m^2 / sqrt(192)``, ``m = 0.1 *
  mscale_all_dim * ln(factor) + 1``, a causal softmax, then ``W_o`` over the
  heads' ``p v`` (through ``F.scaled_dot_product_attention``);
- the first ``first_k_dense_replace`` layers' FFN is a SwiGLU of width
  ``intermediate_size``; every later one is a :class:`MoELayer`: ``y =
  shared(x) + sum over the top-k experts held here of w_e E_e(x)``, the
  router ``W_r x`` in float32 over all ``n_routed_experts``, ``w =
  softmax``, greedy top-k, no renormalisation, scale 1; each ``E_e`` a
  SwiGLU of width ``moe_intermediate_size``, the shared part one SwiGLU of
  ``n_shared_experts`` times that width.

Departures from the published code, none of them in the mathematics: a
SwiGLU's gate and up projections are one weight ``gate_up`` [2W, D]
(gate rows first) and one product; the held experts' weights are stacked,
``experts_gate_up`` [E, 2W, D] and ``experts_down`` [E, D, W]; no
auxiliary balance loss (the published training adds one; a fine-tuned
regressor's loss here is the task's alone).

Expert parallelism: the layer holds experts ``[expert_rank * experts_held,
(expert_rank + 1) * experts_held)``, routes over all of them and computes
its own experts' part of the result, as one chip of a deployment that
divides each layer's experts over ``n_routed_experts / experts_held``
chips; a token whose choices miss every held expert gets the shared part
alone. The rows are sorted into expert order by :class:`MoEDispatch` and
summed back by :class:`MoECombine` (``csrc/moe_dispatch.cu`` on the card,
their plain versions on the CPU), both with static shapes and no host read,
so the step can be replayed as a CUDA graph, and no atomic sum, so a graphed
step equals an eager one bit for bit. The expert products are one
``torch._grouped_mm`` over the held experts (bf16 on the card; a loop of
products elsewhere). The encoder counts, on the device, the rows routed to
each held expert in each MoE layer (``routed_rows`` [layers, held]) and the
tokens with a held slot (``routed_tokens`` [layers]), through every forward,
eager or replayed.

A chip that holds a share of the experts keeps the router's weights
frozen (:meth:`PairMoEEncoder.requires_grad_`): its gradient there is the
held experts' part alone (an absent expert's weight takes none), which a
deployment all-reduces over the ranks and one chip cannot; trained on that
part, the router learns to route away from the held experts, whose random
outputs only add noise (on the STS-B cell, the held rows of the deepest
MoE layer fell from ~7,680 a step to a few within 200 steps). Where the
chip holds every expert the router trains.

Parameters are float32, cast to the module dtype (bf16 on the card) where a
product uses them; the residual stream, RMSNorm and the router run in
float32. No dropout (the published model has none).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck

# DeepSeek-V2-Lite's rope_scaling (YaRN): the original context, the
# extension factor and the correction range's rotations
ROPE_FACTOR = 40.0
ROPE_ORIGINAL_MAX_POSITION = 4096
ROPE_BETA_FAST = 32.0
ROPE_BETA_SLOW = 1.0
ROPE_MSCALE = 0.707
ROPE_MSCALE_ALL_DIM = 0.707


@dataclasses.dataclass
class DeepSeekV2Config:
    """The model's shape, named as its ``config.json`` names it (defaults:
    DeepSeek-V2-Lite's). ``experts_held`` and ``expert_rank``: this chip
    holds experts ``[expert_rank * experts_held, (expert_rank + 1) *
    experts_held)``."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    experts_held: int = 64
    expert_rank: int = 0
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02


def yarn_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def attention_scale(cfg: DeepSeekV2Config) -> float:
    """``m^2 / sqrt(qk_nope_head_dim + qk_rope_head_dim)``: the published
    softmax scale with YaRN's ``mscale_all_dim`` (0.11472 at the Lite's
    widths)."""
    m = yarn_mscale(ROPE_FACTOR, ROPE_MSCALE_ALL_DIM)
    return m * m / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def yarn_inv_freq(dim: int, theta: float, device=None) -> torch.Tensor:
    """YaRN's frequencies (float32 [dim / 2]): ``f_i r + f_e (1 - r)`` with
    ``f_e(i) = theta^(-2i / dim)``, ``f_i = f_e / factor`` and the ramp ``r``
    from 0 at ``floor(d(beta_fast))`` to 1 at ``ceil(d(beta_slow))``, ``d(b) =
    dim ln(max_pos / (2 pi b)) / (2 ln theta)`` (10 and 23 at dim 64)."""
    def correction_dim(rotations: float) -> float:
        return dim * math.log(ROPE_ORIGINAL_MAX_POSITION / (rotations * 2 * math.pi)) / (
            2 * math.log(theta))

    low = max(math.floor(correction_dim(ROPE_BETA_FAST)), 0)
    high = min(math.ceil(correction_dim(ROPE_BETA_SLOW)), dim - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / theta ** exps
    inter = 1.0 / (ROPE_FACTOR * theta ** exps)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    return inter * ramp + extra * (1.0 - ramp)


def rope_tables(steps: int, dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 [steps, dim] of positions 0..steps-1, each half
    the frequencies repeated, scaled by ``mscale / mscale_all_dim`` (1 at
    the Lite's equal values), made on ``device`` (a captured graph copies
    nothing from the host)."""
    freqs = torch.outer(torch.arange(steps, dtype=torch.float32, device=device),
                        yarn_inv_freq(dim, theta, device))
    emb = torch.cat([freqs, freqs], dim=-1)
    scale = yarn_mscale(ROPE_FACTOR, ROPE_MSCALE) / yarn_mscale(ROPE_FACTOR, ROPE_MSCALE_ALL_DIM)
    return emb.cos() * scale, emb.sin() * scale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` [N, L, heads, R] rotated in float32: its R dims viewed as R / 2
    pairs and transposed (the published de-interleave), then ``x cos +
    rotate_half(x) sin`` with cos, sin [L, R]."""
    n, steps, heads, r = x.shape
    x = x.float().view(n, steps, heads, r // 2, 2).transpose(-1, -2).reshape(n, steps, heads, r)
    half = torch.cat([-x[..., r // 2:], x[..., :r // 2]], dim=-1)
    return x * cos[None, :, None] + half * sin[None, :, None]


def _linear(x: torch.Tensor, linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), linear.weight.to(dtype))


class RMSNorm(nn.Module):
    """``w * x / sqrt(mean(x^2) + eps)`` in float32."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return self.weight * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps))


class SwiGLU(nn.Module):
    """``W_d (silu(W_g x) * W_u x)`` of width ``width`` in the module dtype,
    gate and up as one product (``gate_up``, gate rows first)."""

    def __init__(self, d: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.gate_up = nn.Linear(d, 2 * width, bias=False)
        self.down = nn.Linear(width, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = _linear(x, self.gate_up, self.dtype).chunk(2, dim=-1)
        return _linear(F.silu(gate) * up, self.down, self.dtype)


class MLAttention(nn.Module):
    """Multi-head latent attention without query compression (module
    docstring); ``x`` [N, L, D] to [N, L, D] in the module dtype."""

    def __init__(self, cfg: DeepSeekV2Config, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.heads = h = cfg.num_attention_heads
        self.nope, self.rope, self.v_dim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.lora = cfg.kv_lora_rank
        self.scale = attention_scale(cfg)
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, h * (self.nope + self.rope), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, self.lora + self.rope, bias=False)
        self.kv_a_layernorm = RMSNorm(self.lora, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(self.lora, h * (self.nope + self.v_dim), bias=False)
        self.o_proj = nn.Linear(h * self.v_dim, d, bias=False)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        n, steps, _ = x.shape
        h, dt = self.heads, self.dtype
        x = x.to(dt)
        q = _linear(x, self.q_proj, dt).view(n, steps, h, self.nope + self.rope)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        c, k_pe = _linear(x, self.kv_a_proj_with_mqa, dt).split([self.lora, self.rope], dim=-1)
        kv = _linear(self.kv_a_layernorm(c), self.kv_b_proj, dt)
        k_nope, v = kv.view(n, steps, h, self.nope + self.v_dim).split([self.nope, self.v_dim], -1)
        q_pe = apply_rope(q_pe, cos, sin).to(dt)
        k_pe = apply_rope(k_pe[:, :, None], cos, sin).to(dt).expand(n, steps, h, self.rope)
        q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v.transpose(1, 2), is_causal=True,
                                           scale=self.scale)
        return _linear(o.transpose(1, 2).reshape(n, steps, h * self.v_dim), self.o_proj, dt)


class MoEDispatch(torch.autograd.Function):
    """``x`` [T, D] to (xs [cap, D], pos [T, K], offs [held]) of the held
    slots of ``idx`` (:func:`ops.cuda_kernels.moe_dispatch`, which adds to
    the counters ``rows`` and ``touched``); backward, ``dxs`` to ``dx`` by
    :func:`ops.cuda_kernels.moe_dispatch_backward`."""

    @staticmethod
    def forward(ctx, x, idx, lo: int, held: int, rows, touched):
        xs, pos, offs = ck.moe_dispatch(x.contiguous(), idx.contiguous(), lo, held, rows, touched)
        ctx.mark_non_differentiable(pos, offs)
        ctx.save_for_backward(pos)
        return xs, pos, offs

    @staticmethod
    def backward(ctx, dxs, _pos, _offs):
        (pos,) = ctx.saved_tensors
        return ck.moe_dispatch_backward(dxs.contiguous(), pos), None, None, None, None, None


class MoECombine(torch.autograd.Function):
    """The expert rows ``y`` [cap, D] weighted by ``w`` [T, K] and summed per
    token into [T, D] float32 (:func:`ops.cuda_kernels.moe_combine`);
    backward :func:`ops.cuda_kernels.moe_combine_backward`."""

    @staticmethod
    def forward(ctx, y, w, pos):
        ctx.save_for_backward(y, w, pos)
        return ck.moe_combine(y.contiguous(), w.contiguous(), pos)

    @staticmethod
    def backward(ctx, dout):
        y, w, pos = ctx.saved_tensors
        dy, dw = ck.moe_combine_backward(dout.contiguous(), y, w, pos)
        return dy, dw, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows ``[offs[e - 1], offs[e])`` of ``x`` [M, K] times ``w[e]ᵀ`` (``w``
    [E, N, K]) for each held expert ``e``, as [M, N]: one
    ``torch._grouped_mm`` for bf16 on the card (the rows past ``offs[-1]``
    are left as they fall), else a loop of products that reads the offsets
    on the host (zeros past ``offs[-1]``)."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w.transpose(-2, -1), offs)
    ends = offs.tolist()
    parts, start = [], 0
    for e, end in enumerate(ends):
        parts.append(x[start:end] @ w[e].T)
        start = end
    parts.append(x.new_zeros(x.shape[0] - start, w.shape[1]))
    return torch.cat(parts)


class MoELayer(nn.Module):
    """The DeepSeekMoE FFN of one chip's share (module docstring): ``x``
    [T, D] float32 to [T, D] float32, the routed rows counted into ``rows``
    [held] and the tokens with a held slot into ``touched`` [1]."""

    def __init__(self, cfg: DeepSeekV2Config, dtype: torch.dtype):
        super().__init__()
        if not 1 <= cfg.experts_held <= cfg.n_routed_experts or \
                (cfg.expert_rank + 1) * cfg.experts_held > cfg.n_routed_experts or cfg.expert_rank < 0:
            raise ValueError(f"experts [{cfg.expert_rank * cfg.experts_held}, "
                             f"{(cfg.expert_rank + 1) * cfg.experts_held}) are not among the "
                             f"{cfg.n_routed_experts} routed experts")
        self.dtype = dtype
        self.top_k = cfg.num_experts_per_tok
        self.held = cfg.experts_held
        self.lo = cfg.expert_rank * cfg.experts_held
        d, width = cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = nn.Linear(d, cfg.n_routed_experts, bias=False)
        self.experts_gate_up = nn.Parameter(torch.empty(self.held, 2 * width, d))
        self.experts_down = nn.Parameter(torch.empty(self.held, d, width))
        self.shared_experts = SwiGLU(d, cfg.n_shared_experts * width, dtype)

    def route(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weights [T, K] float32, experts [T, K] int64): the greedy top-k
        of the router's softmax over all experts, on ``x`` in the module
        dtype taken to float32."""
        logits = F.linear(x.float(), self.gate.weight.float())
        return logits.softmax(dim=-1).topk(self.top_k, dim=-1)

    def forward(self, x: torch.Tensor, rows: torch.Tensor, touched: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        w, idx = self.route(x)
        out = self.shared_experts(x).float()
        xs, pos, offs = MoEDispatch.apply(x, idx, self.lo, self.held, rows, touched)
        gate, up = grouped_mm(xs, self.experts_gate_up.to(dt), offs).chunk(2, dim=-1)
        ys = grouped_mm(F.silu(gate) * up, self.experts_down.to(dt), offs)
        return out + MoECombine.apply(ys, w, pos)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepSeekV2Config, dense: bool, dtype: torch.dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLAttention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype) if dense \
            else MoELayer(cfg, dtype)

    def forward(self, h, cos, sin, counters=None):
        h = h + self.self_attn(self.input_layernorm(h), cos, sin)
        x = self.post_attention_layernorm(h)
        if counters is None:
            return h + self.mlp(x)
        return h + self.mlp(x.flatten(0, 1), *counters).view(h.shape)


class PairMoEEncoder(nn.Module):
    """Sentence-pair encoder: a batch ``{"tokens1", "mask1", "tokens2",
    "mask2"}`` to the pair feature [B, 4 * hidden_size] in float32 (module
    docstring)."""

    def __init__(self, config: DeepSeekV2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.out_features = 4 * config.hidden_size
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleList(
            DecoderLayer(config, i < config.first_k_dense_replace, dtype)
            for i in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        moe = max(config.num_hidden_layers - config.first_k_dense_replace, 0)
        self.register_buffer("routed_rows", torch.zeros(moe, config.experts_held, dtype=torch.int64),
                             persistent=False)
        self.register_buffer("routed_tokens", torch.zeros(moe, dtype=torch.int64), persistent=False)
        self.reset_parameters()
        self.requires_grad_(True)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Normal weights of sd ``initializer_range`` (the published
        ``_init_weights``), RMSNorm weights 1."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if isinstance(self.get_submodule(name.rsplit(".", 1)[0]), RMSNorm):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, self.config.initializer_range, generator=generator)

    def requires_grad_(self, requires_grad: bool = True) -> "PairMoEEncoder":
        """As ``nn.Module.requires_grad_``, but the routers of a chip that
        holds a share of the experts never require a gradient (module
        docstring)."""
        super().requires_grad_(requires_grad)
        if self.config.experts_held < self.config.n_routed_experts:
            for layer in self.layers:
                if isinstance(layer.mlp, MoELayer):
                    layer.mlp.gate.weight.requires_grad_(False)
        return self

    def reset_counters(self) -> None:
        """Zero ``routed_rows`` and ``routed_tokens`` in place (a captured
        graph keeps adding into the same tensors)."""
        self.routed_rows.zero_()
        self.routed_tokens.zero_()

    def encode(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Sentence encodings [N, hidden_size] in float32: the final
        RMSNorm's states averaged over each row's valid positions."""
        cfg = self.config
        h = self.embed_tokens(tokens.long())
        cos, sin = rope_tables(tokens.shape[1], cfg.qk_rope_head_dim, cfg.rope_theta, h.device)
        first = cfg.first_k_dense_replace
        for i, layer in enumerate(self.layers):
            counters = None if i < first else (self.routed_rows[i - first],
                                               self.routed_tokens[i - first:i - first + 1])
            h = layer(h, cos, sin, counters)
        m = mask[..., None].float()
        return (self.norm(h) * m).sum(1) / m.sum(1).clamp(min=1.0)

    def forward(self, batch: dict, generator=None) -> torch.Tensor:
        steps = max(batch["tokens1"].shape[1], batch["tokens2"].shape[1])
        pad = lambda a: F.pad(a, (0, steps - a.shape[1]))  # noqa: E731
        tokens = torch.cat([pad(batch["tokens1"]), pad(batch["tokens2"])])
        mask = torch.cat([pad(batch["mask1"]), pad(batch["mask2"])])
        s1, s2 = self.encode(tokens, mask).chunk(2)
        return torch.cat([s1, s2, (s1 - s2).abs(), s1 * s2], dim=1)
