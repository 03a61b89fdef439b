"""Model operations of the DeepSeek-V2 sentence-pair network (one chip's
share: the configuration's layers and held experts), counted from its
shapes over the real tokens only (padding positions are not required
work), two operations a multiply-add:

- each layer's attention projections, ``2 D (H (nope + rope)) + 2 D (lora +
  rope) + 2 lora (H (nope + v)) + 2 (H v) D`` a token, and its scores and
  values, ``2 H (nope + rope + v)`` a token for each position it sees (a
  sentence of n tokens: n (n + 1) / 2 pairs, causal);
- the dense layers' SwiGLU, ``6 D W`` a token;
- each MoE layer's router ``2 D E_routed``, its shared experts ``6 D
  (n_shared W_moe)`` and its routed experts at their expected share here,
  ``top_k * experts_held / n_routed`` experts of ``6 D W_moe`` a token;
- the head, ``2 * 4 D`` a pair.

Norms, the rotation, softmax, activations, the dispatch and the pooling
are not counted."""

from __future__ import annotations

import numpy as np


def per_token(m: dict) -> tuple[float, float]:
    """(operations a token outside the attention's scores, operations of
    the scores and values for each position a token sees)."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    nope, rope, v, lora = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"], \
        m["kv_lora_rank"]
    proj = 2.0 * d * h * (nope + rope) + 2.0 * d * (lora + rope) + 2.0 * lora * h * (nope + v) \
        + 2.0 * h * v * d
    dense = m["first_k_dense_replace"]
    moe_layers = m["num_hidden_layers"] - dense
    w = m["moe_intermediate_size"]
    routed = m["num_experts_per_tok"] * m["experts_held"] / m["n_routed_experts"]
    moe = 2.0 * d * m["n_routed_experts"] + 6.0 * d * m["n_shared_experts"] * w \
        + routed * 6.0 * d * w
    total = m["num_hidden_layers"] * proj + dense * 6.0 * d * m["intermediate_size"] \
        + moe_layers * moe
    return total, m["num_hidden_layers"] * 2.0 * h * (nope + rope + v)


def forward_flops(model: dict, lengths) -> float:
    """Operations of a forward pass over sentences of ``lengths`` real
    tokens (both sentences of each pair; the pairs are half as many)."""
    n = np.asarray(lengths, np.float64)
    token, seen = per_token(model)
    pairs = n.size / 2
    return float(token * n.sum() + seen * (n * (n + 1) / 2).sum()
                 + 2.0 * 4 * model["hidden_size"] * pairs)
