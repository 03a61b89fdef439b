"""Model operations of the BiLSTM sentence-pair network, counted from its
shapes over the real tokens only (padding steps are not required work):
for each real token, each layer and each direction, the input projection
``2 * 4H * D_in`` and the recurrent product ``2 * 4H * H``; plus the head.
Gate nonlinearities, dropout and pooling are not counted."""

from __future__ import annotations


def flops_per_token(model: dict) -> float:
    h, total = model["d_hid"], 0.0
    for layer in range(model["n_layers"]):
        d_in = model["d_word"] if layer == 0 else 2 * h
        total += 2 * (2.0 * 4 * h * d_in + 2.0 * 4 * h * h)
    return total


def forward_flops(model: dict, real_tokens: float, pairs: int) -> float:
    """Operations of a forward pass over ``pairs`` sentence pairs holding
    ``real_tokens`` tokens in all (both sentences)."""
    return flops_per_token(model) * real_tokens + 2.0 * 8 * model["d_hid"] * pairs
