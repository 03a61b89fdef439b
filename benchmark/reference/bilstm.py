"""The STS-B-DIR sentence-pair network in plain PyTorch, float32: a frozen
word embedding, dropout, a stacked bidirectional LSTM, dropout, a max-pool
over each sentence's words, the pair feature ``[s1; s2; |s1 - s2|; s1 *
s2]`` (``sts-b-dir/models.py``) and one linear output.

The LSTM is the fused layout the configuration runs: one weight set a layer
for both directions (the backward direction reads each sentence's words in
reverse order, padding left in place), gates ``x W_i^T + b + h W_h`` in the
order i, f, g, o. Dropout keeps a value where a uniform draw is below ``1 -
rate`` and scales it by ``1 / (1 - rate)``; the draws are made from the
generator handed in, one ``torch.rand`` of the embeddings' shape, then one
of the LSTM output's, for the two sentences stacked."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.optim import operand


def layout(vocab: int, d_word: int, d_hid: int, n_layers: int):
    """``{name: (shape, init)}`` of the encoder and the head, keyed as the
    program's ``state_dict`` keys them; ``init`` is ``("normal", std)`` or
    ``("const", value)``; the embedding's padding row is zeroed after the
    draw."""
    enc = {"embed.weight": ((vocab, d_word), ("normal", 0.5))}
    for layer in range(n_layers):
        width = d_word if layer == 0 else 2 * d_hid
        enc[f"bilstm.input_proj_{layer}.weight"] = ((4 * d_hid, width),
                                                    ("normal", math.sqrt(1.0 / width)))
        enc[f"bilstm.input_proj_{layer}.bias"] = ((4 * d_hid,), ("const", 0.0))
        enc[f"bilstm.recurrent_kernel_{layer}"] = ((d_hid, 4 * d_hid),
                                                   ("normal", math.sqrt(1.0 / d_hid)))
    d = 8 * d_hid
    head = {"linear.weight": ((1, d), ("normal", math.sqrt(1.0 / d))),
            "linear.bias": ((1,), ("const", 0.0))}
    return enc, head


def reverse_words(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's first ``length`` steps in reverse order, the rest in
    place."""
    out = x.clone()
    for i, n in enumerate(lengths.tolist()):
        out[i, :n] = x[i, :n].flip(0)
    return out


class PairRegressor:
    def __init__(self, enc: dict, head: dict, n_layers: int, dropout: float,
                 dropout_embs: float, rounding: str | None = None):
        self.enc, self.head, self.n_layers = enc, head, n_layers
        self.dropout, self.dropout_embs, self.rounding = dropout, dropout_embs, rounding

    def _mm(self, a, b):
        return operand(a, self.rounding) @ operand(b, self.rounding)

    @staticmethod
    def _drop(x, rate, generator):
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def _lstm(self, x, lengths):
        rows = x.shape[0]
        for layer in range(self.n_layers):
            w_i = self.enc[f"bilstm.input_proj_{layer}.weight"]
            b_i = self.enc[f"bilstm.input_proj_{layer}.bias"]
            w_h = self.enc[f"bilstm.recurrent_kernel_{layer}"]
            xx = torch.cat([x, reverse_words(x, lengths)])
            xw = self._mm(xx, w_i.t()) + b_i
            h = torch.zeros(xx.shape[0], w_h.shape[0], device=x.device)
            c = torch.zeros_like(h)
            hs = []
            for t in range(xx.shape[1]):
                i, f, g, o = operand(xw[:, t] + self._mm(h, w_h), self.rounding).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs.append(h)
            hs = torch.stack(hs, dim=1)
            x = operand(torch.cat([hs[:rows], reverse_words(hs[rows:], lengths)], dim=-1),
                        self.rounding)
        return x

    def encode(self, batch: dict, generator, train: bool) -> torch.Tensor:
        """The pair feature [B, 8 d_hid] of ``batch`` (``tokens1``,
        ``mask1``, ``tokens2``, ``mask2``, each [B, L])."""
        tokens = torch.cat([batch["tokens1"], batch["tokens2"]]).long()
        mask = torch.cat([batch["mask1"], batch["mask2"]])
        x = self.enc["embed.weight"].detach()[tokens]
        if train:
            x = self._drop(x, self.dropout_embs, generator)
        lengths = mask.sum(1).long()
        x = self._lstm(x, lengths)
        if train:
            x = self._drop(x, self.dropout, generator)
        pooled = torch.where(mask[..., None] > 0, x, torch.full_like(x, -math.inf)).amax(1)
        s1, s2 = pooled.chunk(2)
        return torch.cat([s1, s2, (s1 - s2).abs(), s1 * s2], dim=1)

    def predict(self, feature: torch.Tensor) -> torch.Tensor:
        w = operand(self.head["linear.weight"], self.rounding)
        return F.linear(operand(feature, self.rounding), w, self.head["linear.bias"])
