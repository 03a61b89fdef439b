"""DeepSeek-V2 as the STS-B-DIR sentence-pair encoder in plain PyTorch,
float32: the reference of the ``moe_pair`` family.

The network of DeepSeek-V2 (DeepSeek-AI, 2024; the ``modeling_deepseek.py``
published with DeepSeek-V2-Lite), written out from its equations: a token
embedding; for each layer ``h += Attn(RMSNorm(h))`` and ``h +=
FFN(RMSNorm(h))``; a final RMSNorm; each sentence's valid positions
averaged; the pair feature ``[s1; s2; |s1 - s2|; s1 * s2]``; one linear
output.

- Attention (MLA, no query compression), head by head as explicit
  products: ``q = W_q h`` (nope + rope dims a head), ``[c; k_pe] = W_kva
  h``, ``[k_nope; v] = W_kvb RMSNorm(c)``; the rope parts (``q_pe`` a head
  and one ``k_pe`` for all heads) are read as pairs, de-interleaved, and
  rotated by ``x cos + rotate_half(x) sin`` at YaRN's frequencies from the
  configuration's ``rope_scaling``; scores ``(q_nope . k_nope + q_pe . k_pe)
  * mscale(all_dim)^2 / sqrt(nope + rope)``, a causal mask, a softmax,
  ``p v``, then ``W_o`` over the heads.
- FFN: SwiGLU ``W_d (silu(W_g x) * W_u x)``; the first
  ``first_k_dense_replace`` layers dense, the others DeepSeekMoE: the
  router ``x W_r^T`` in float32 over all ``n_routed_experts``, a softmax,
  the greedy top ``num_experts_per_tok`` (not renormalised, scale 1); the
  shared experts as one SwiGLU; then, for each expert this chip holds
  (``[expert_rank * experts_held, ...)``), the tokens that chose it, picked
  by a boolean mask, through its SwiGLU and added with their weight. The
  experts not held here add nothing, as on the chip that runs the program.
  No auxiliary balance loss.

Where the chip holds a share of the experts the router's weights are no
leaf of training (:func:`trained`): their gradient here is the held
experts' part alone, which a deployment all-reduces over the ranks.
Weights are keyed as the program's ``state_dict`` keys them
(:func:`layout`); a SwiGLU's gate and up projections are one matrix
``gate_up`` [2W, D], gate rows first, and the held experts' are stacked
([E, 2W, D] and [E, D, W]). ``rounding`` (:mod:`reference.optim`) rounds
the operands of every product and the states the program keeps in bf16.
No kernels, no graphs, no batching tricks."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.optim import operand


def layout(cfg: dict):
    """``{name: (shape, init)}`` of the encoder and the head: normal weights
    of sd ``initializer_range``, RMSNorm weights 1, the STS-B head normal of
    variance 1 / its width with a zero bias."""
    d, h, std = cfg["hidden_size"], cfg["num_attention_heads"], cfg["initializer_range"]
    nope, rope, vd, lora = (cfg[k] for k in ("qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
                                             "kv_lora_rank"))
    w = lambda *shape: (shape, ("normal", std))  # noqa: E731
    one = lambda n: ((n,), ("const", 1.0))  # noqa: E731
    enc = {"embed_tokens.weight": w(cfg["vocab_size"], d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        enc.update({
            p + "input_layernorm.weight": one(d),
            p + "self_attn.q_proj.weight": w(h * (nope + rope), d),
            p + "self_attn.kv_a_proj_with_mqa.weight": w(lora + rope, d),
            p + "self_attn.kv_a_layernorm.weight": one(lora),
            p + "self_attn.kv_b_proj.weight": w(h * (nope + vd), lora),
            p + "self_attn.o_proj.weight": w(d, h * vd),
            p + "post_attention_layernorm.weight": one(d)})
        if i < cfg["first_k_dense_replace"]:
            width = cfg["intermediate_size"]
            enc.update({p + "mlp.gate_up.weight": w(2 * width, d),
                        p + "mlp.down.weight": w(d, width)})
        else:
            width, held = cfg["moe_intermediate_size"], cfg["experts_held"]
            shared = cfg["n_shared_experts"] * width
            enc.update({p + "mlp.gate.weight": w(cfg["n_routed_experts"], d),
                        p + "mlp.experts_gate_up": w(held, 2 * width, d),
                        p + "mlp.experts_down": w(held, d, width),
                        p + "mlp.shared_experts.gate_up.weight": w(2 * shared, d),
                        p + "mlp.shared_experts.down.weight": w(d, shared)})
    enc["norm.weight"] = one(d)
    f = 4 * d
    head = {"linear.weight": ((1, f), ("normal", math.sqrt(1.0 / f))),
            "linear.bias": ((1,), ("const", 0.0))}
    return enc, head


def trained(cfg: dict, name: str) -> bool:
    """Whether the encoder's weight ``name`` trains: all but the routers of
    a chip that holds a share of the experts."""
    return cfg["experts_held"] == cfg["n_routed_experts"] or not name.endswith("mlp.gate.weight")


def _mscale(scale: float, m: float) -> float:
    return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0


def rope_cos_sin(cfg: dict, steps: int, device):
    """cos and sin [steps, rope dims] of YaRN (``rope_scaling``): each
    frequency ``theta^(-2i/dim)`` blended with it over ``factor`` along a
    linear ramp between the correction dims of ``beta_fast`` and
    ``beta_slow`` (floor and ceil), the angles of positions 0..steps-1
    repeated over both halves, times ``mscale / mscale_all_dim``."""
    rs, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], cfg["rope_theta"]

    def corr(rot):
        return dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    lo = max(math.floor(corr(rs["beta_fast"])), 0)
    hi = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    hi = hi + 0.001 if hi == lo else hi
    i = torch.arange(dim // 2, dtype=torch.float32)
    extra = base ** (-2.0 * i / dim)
    inter = extra / rs["factor"]
    ramp = ((i - lo) / (hi - lo)).clamp(0.0, 1.0)
    freq = inter * ramp + extra * (1.0 - ramp)
    angles = torch.arange(steps, dtype=torch.float32)[:, None] * freq[None, :]
    angles = torch.cat([angles, angles], dim=1).to(device)
    scale = _mscale(rs["factor"], rs["mscale"]) / _mscale(rs["factor"], rs["mscale_all_dim"])
    return angles.cos() * scale, angles.sin() * scale


def rotate(x, cos, sin):
    """``x`` [..., L, R]: pairs (x0, x1), (x2, x3), ... regrouped as (x0, x2,
    ..., x1, x3, ...), then ``x cos + rotate_half(x) sin``."""
    r = x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    half = torch.cat([-x[..., r // 2:], x[..., :r // 2]], dim=-1)
    return x * cos + half * sin


class PairRegressor:
    def __init__(self, enc: dict, head: dict, cfg: dict, rounding: str | None = None):
        self.enc, self.head, self.cfg, self.rounding = enc, head, cfg, rounding

    def _r(self, t):
        return operand(t, self.rounding)

    def _lin(self, x, name):
        return self._r(self._r(x) @ self._r(self.enc[name]).t())

    def _rms(self, x, name):
        return self.enc[name] * x / torch.sqrt((x * x).mean(-1, keepdim=True)
                                               + self.cfg["rms_norm_eps"])

    def _swiglu(self, x, gate_up, down):
        g, u = (self._r(self._r(x) @ self._r(gate_up).t())).chunk(2, dim=-1)
        return self._r(self._r(F.silu(g) * u) @ self._r(down).t())

    def attention(self, x, p: str, cos, sin):
        """``x`` [N, L, D] (normed) to the attention's output [N, L, D]."""
        cfg = self.cfg
        n, steps, _ = x.shape
        h, nope, rope, vd, lora = (cfg[k] for k in ("num_attention_heads", "qk_nope_head_dim",
                                                    "qk_rope_head_dim", "v_head_dim",
                                                    "kv_lora_rank"))
        q = self._lin(x, p + "q_proj.weight").view(n, steps, h, nope + rope)
        ckv = self._lin(x, p + "kv_a_proj_with_mqa.weight")
        c, k_pe = ckv[..., :lora], ckv[..., lora:]
        kv = self._lin(self._rms(c, p + "kv_a_layernorm.weight"), p + "kv_b_proj.weight")
        kv = kv.view(n, steps, h, nope + vd)
        k_pe = self._r(rotate(k_pe, cos, sin))  # [N, L, R], one for all heads
        causal = torch.ones(steps, steps, dtype=torch.bool, device=x.device).tril()
        scale = _mscale(cfg["rope_scaling"]["factor"],
                        cfg["rope_scaling"]["mscale_all_dim"]) ** 2 / math.sqrt(nope + rope)
        heads = []
        for i in range(h):
            q_nope, q_pe = q[:, :, i, :nope], self._r(rotate(q[:, :, i, nope:], cos, sin))
            k_nope, v = kv[:, :, i, :nope], kv[:, :, i, nope:]
            s = (q_nope @ k_nope.transpose(1, 2) + q_pe @ k_pe.transpose(1, 2)) * scale
            prob = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
            heads.append(self._r(self._r(prob) @ v))
        return self._lin(torch.cat(heads, dim=-1), p + "o_proj.weight")

    def moe(self, x, p: str):
        """``x`` [T, D] (normed) to the shared experts plus the held experts'
        weighted outputs [T, D]."""
        cfg = self.cfg
        xr = self._r(x)
        logits = xr @ self.enc[p + "gate.weight"].t()
        weight, chosen = torch.softmax(logits, dim=-1).topk(cfg["num_experts_per_tok"], dim=-1)
        out = self._swiglu(xr, self.enc[p + "shared_experts.gate_up.weight"],
                           self.enc[p + "shared_experts.down.weight"])
        lo = cfg["expert_rank"] * cfg["experts_held"]
        for e in range(cfg["experts_held"]):
            hit = chosen == lo + e  # [T, K]
            picked = hit.any(dim=-1)
            if not bool(picked.any()):
                continue
            y = self._swiglu(xr[picked], self.enc[p + "experts_gate_up"][e],
                             self.enc[p + "experts_down"][e])
            w = (weight * hit).sum(dim=-1)[picked]
            out = out.index_put((picked.nonzero()[:, 0],), w[:, None] * y, accumulate=True)
        return out

    def encode(self, batch: dict) -> torch.Tensor:
        """The pair feature [B, 4 D] of ``batch`` (``tokens1``, ``mask1``,
        ``tokens2``, ``mask2``, each [B, L])."""
        cfg = self.cfg
        tokens = torch.cat([batch["tokens1"], batch["tokens2"]]).long()
        mask = torch.cat([batch["mask1"], batch["mask2"]])
        n, steps = tokens.shape
        h = self.enc["embed_tokens.weight"][tokens]
        cos, sin = rope_cos_sin(cfg, steps, h.device)
        for i in range(cfg["num_hidden_layers"]):
            p = f"layers.{i}."
            h = h + self.attention(self._rms(h, p + "input_layernorm.weight"),
                                   p + "self_attn.", cos, sin)
            x = self._rms(h, p + "post_attention_layernorm.weight")
            if i < cfg["first_k_dense_replace"]:
                h = h + self._swiglu(x, self.enc[p + "mlp.gate_up.weight"],
                                     self.enc[p + "mlp.down.weight"])
            else:
                h = h + self.moe(x.reshape(n * steps, -1), p + "mlp.").view(h.shape)
        m = mask[..., None]
        pooled = (self._rms(h, "norm.weight") * m).sum(1) / m.sum(1).clamp(min=1.0)
        s1, s2 = pooled.chunk(2)
        return torch.cat([s1, s2, (s1 - s2).abs(), s1 * s2], dim=1)

    def predict(self, feature: torch.Tensor) -> torch.Tensor:
        w = operand(self.head["linear.weight"], self.rounding)
        return F.linear(operand(feature, self.rounding), w, self.head["linear.bias"])
