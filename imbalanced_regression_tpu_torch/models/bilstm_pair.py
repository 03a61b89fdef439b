"""GloVe + BiLSTM sentence-pair encoder for STS-B on PyTorch.

The JAX package's ``models/bilstm_pair.py`` (reference AllenNLP stack,
``sts-b-dir/models.py:16-166``): embedding (GloVe table, frozen unless
``train_words``) → highway (0 layers by default) → 2-layer bidirectional
LSTM (``d_hid`` = 1500 a direction) → masked max-pool → pair features
``[s1; s2; |s1-s2|; s1*s2]`` (8·d_hid = 12000-d). The final linear is
:class:`models.resnet.RegressionHead`, so FDS calibrates the pair embedding
between the two.

Two layouts of the LSTM, as in the JAX package (``lstm_impl``): ``"fused"``
(:class:`FusedBiLSTM`, the default) and ``"flax"`` (:class:`BiLSTM`, the
per-direction layout of the JAX package's checkpoints written before its
round 4). The fused recurrence is the JAX ``FusedBiLSTM``'s, not
``nn.LSTM``'s:

- the input projection of every time step is one product ``[2B·L, D] x
  [D, 4H]`` before the loop; only ``h @ W_h`` runs step by step;
- both directions share one weight set per layer: the backward direction
  runs on the packed reversal of each sequence (:func:`flip_padded`) as
  further rows of one doubled batch. The reference (and the JAX ``BiLSTM``)
  has a weight set per direction; the port copies the JAX package's
  departure, so the two hold the same parameters;
- gates ``xw_t + bf16(h) @ bf16(W_h)`` are summed in the module dtype (bf16
  at full width) and cast to float32, gate order i, f, g, o; the cell and
  hidden states stay float32.

:class:`BiLSTM` keeps a weight set per direction and Flax's
``OptimizedLSTMCell`` numerics (below). Neither layout runs ``nn.LSTM``:
cuDNN's packed-sequence path adds a second bias, another parameterisation.

Parameters are float32 and cast to the module dtype where they are used,
as Flax's ``dtype=bf16, param_dtype=f32``. Dropout (of the embeddings,
then of the LSTM output) draws from the generator the caller passes, in
train mode only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from imbalanced_regression_tpu_torch.models.resnet import dense_reset_, lecun_normal_
from imbalanced_regression_tpu_torch.parallel import mesh as dp


def dropout(x: torch.Tensor, rate: float, generator, groups: int = 1) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1 / (1 - rate)``. ``generator`` may be a
    :class:`parallel.mesh.ShardedGenerator`, whose draw is this rank's rows
    of the global batch's; ``groups`` is the number of batch blocks stacked
    along the leading axis (2 for the pair's two sentence columns)."""
    if rate == 0.0:
        return x
    keep = dp.rand(x.shape, generator, x.device, groups) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _dense(x: torch.Tensor, linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), linear.weight.to(dtype), linear.bias.to(dtype))


class Highway(nn.Module):
    """``y = g * relu(W1 x) + (1 - g) * x``, ``g = sigmoid(W2 x)`` (AllenNLP
    Highway); ``W1`` and ``W2`` are the halves of one Dense of width 2d."""

    def __init__(self, d: int, n_layers: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(nn.Linear(d, 2 * d) for _ in range(n_layers))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in self.layers:
            dense_reset_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            nonlin, gate = _dense(x, layer, self.dtype).chunk(2, dim=-1)
            g = torch.sigmoid(gate)
            x = g * F.relu(nonlin) + (1.0 - g) * x
        return x


def flip_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's valid prefix along time (axis 1), leaving the
    trailing padding in place: the packed-sequence reversal. Applying it
    twice restores ``x``."""
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    n = lengths.to(t.dtype)[:, None]
    src = torch.where(t < n, n - 1 - t, t)
    return torch.gather(x, 1, src[..., None].expand(-1, -1, x.shape[2]))


def block_orthogonal_(w: torch.Tensor, generator: torch.Generator | None) -> None:
    """Four orthogonal (H, H) gate blocks side by side in ``w`` [H, 4H]: the
    distribution of Flax's ``orthogonal()`` drawn per gate (the QR of a
    normal matrix, columns signed by R's diagonal), the QR in float64."""
    h = w.shape[0]
    assert w.shape == (h, 4 * h), w.shape
    with torch.no_grad():
        for k in range(4):
            a = torch.randn(h, h, generator=generator, dtype=torch.float64)
            q, r = torch.linalg.qr(a)
            q = q * torch.sign(torch.diagonal(r))[None, :]
            w[:, k * h:(k + 1) * h] = q.to(w.dtype)


class FusedBiLSTM(nn.Module):
    """Stacked bidirectional LSTM with the input projection hoisted out of
    the loop and both directions as rows of one batch (module docstring).
    Output [B, L, 2H] in the module dtype: forward then backward states."""

    def __init__(self, d_in: int, hidden_size: int, n_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.dtype = dtype
        for layer in range(n_layers):
            width = d_in if layer == 0 else 2 * hidden_size
            setattr(self, f"input_proj_{layer}", nn.Linear(width, 4 * hidden_size))
            self.register_parameter(f"recurrent_kernel_{layer}",
                                    nn.Parameter(torch.empty(hidden_size, 4 * hidden_size)))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in range(self.n_layers):
            dense_reset_(getattr(self, f"input_proj_{layer}"), generator)
            block_orthogonal_(getattr(self, f"recurrent_kernel_{layer}"), generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        n_rows = x.shape[0]
        for layer in range(self.n_layers):
            xx = torch.cat([x, flip_padded(x, lengths)], dim=0)  # [2B, L, D]
            xw = _dense(xx, getattr(self, f"input_proj_{layer}"), self.dtype)  # [2B, L, 4H]
            wh = getattr(self, f"recurrent_kernel_{layer}").to(self.dtype)
            c = torch.zeros(xx.shape[0], self.hidden_size, device=x.device)
            h = torch.zeros_like(c)
            hs = []
            # unbind, not xw[:, t]: the backward of 40 slices would add 40
            # zero-filled copies of the whole [2B, L, 4H] gradient; unbind's
            # stacks the steps' gradients once
            for xt in xw.unbind(1):
                gates = (xt + h.to(self.dtype) @ wh).float()
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs.append(h)
            hs = torch.stack(hs, dim=1)  # [2B, L, H] float32
            out_b = flip_padded(hs[n_rows:], lengths)
            x = torch.cat([hs[:n_rows], out_b], dim=-1).to(self.dtype)
        return x


class BiLSTM(nn.Module):
    """Stacked bidirectional LSTM with a weight set per direction: the JAX
    package's ``BiLSTM`` (``lstm_impl="flax"``), two
    ``nn.RNN(nn.OptimizedLSTMCell)`` a layer, the backward one run with
    ``reverse=True, keep_order=True, seq_lengths=lengths``.

    Flax's cell, read from its source (flax 0.12): the input kernels ``ii,
    if, ig, io`` [D, H] have no bias, the recurrent kernels ``hi, hf, hg,
    ho`` [H, H] carry the bias; gate order i, f, g, o. A step computes, in
    the module dtype, ``(bf16(h) @ W_h + b) + bf16(x_t) @ W_i``, the gate
    nonlinearities and ``i * g``; the carry starts as float32 zeros (the
    cell's ``param_dtype``), so ``c = f * c + i * g`` and ``h = o *
    tanh(c)`` are float32, and so is the output [B, L, 2H].

    Layer ``l`` holds both directions stacked (0 forward, 1 backward):
    ``input_kernels_{l}`` [2, D, 4H], ``recurrent_kernels_{l}`` [2, H, 4H],
    ``recurrent_biases_{l}`` [2, 4H], the four gates side by side. As in
    :class:`FusedBiLSTM`, the input projections of every step are one
    product before the loop and the backward direction runs on the packed
    reversal (:func:`flip_padded`); the two directions step together as one
    batched product a step. On the valid positions this equals Flax's
    reversal, which also reverses the padding."""

    def __init__(self, d_in: int, hidden_size: int, n_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.dtype = dtype
        h = hidden_size
        for layer in range(n_layers):
            width = d_in if layer == 0 else 2 * h
            self.register_parameter(f"input_kernels_{layer}",
                                    nn.Parameter(torch.empty(2, width, 4 * h)))
            self.register_parameter(f"recurrent_kernels_{layer}",
                                    nn.Parameter(torch.empty(2, h, 4 * h)))
            self.register_parameter(f"recurrent_biases_{layer}",
                                    nn.Parameter(torch.empty(2, 4 * h)))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The cell's initializers: lecun-normal input kernels (fan-in D, as
        each gate's [D, H] block has), an orthogonal [H, H] block a gate
        for the recurrent kernels, zero biases."""
        with torch.no_grad():
            for layer in range(self.n_layers):
                wi = getattr(self, f"input_kernels_{layer}")
                wh = getattr(self, f"recurrent_kernels_{layer}")
                for direction in range(2):
                    lecun_normal_(wi[direction], wi.shape[1], generator)
                    block_orthogonal_(wh[direction], generator)
                getattr(self, f"recurrent_biases_{layer}").zero_()

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        n_rows, steps = x.shape[:2]
        h_dim, dt = self.hidden_size, self.dtype
        for layer in range(self.n_layers):
            wi = getattr(self, f"input_kernels_{layer}").to(dt)
            wh = getattr(self, f"recurrent_kernels_{layer}").to(dt)
            bh = getattr(self, f"recurrent_biases_{layer}").to(dt)[:, None, :]
            xx = torch.stack([x, flip_padded(x, lengths)]).to(dt)  # [2, B, L, D]
            xw = torch.bmm(xx.flatten(1, 2), wi).view(2, n_rows, steps, 4 * h_dim)
            c = torch.zeros(2, n_rows, h_dim, device=x.device)
            h = torch.zeros_like(c)
            hs = []
            for xt in xw.unbind(2):  # unbind: see FusedBiLSTM.forward
                gates = (torch.bmm(h.to(dt), wh) + bh) + xt
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f).float() * c + (torch.sigmoid(i) * torch.tanh(g)).float()
                h = torch.sigmoid(o).float() * torch.tanh(c)
                hs.append(h)
            hs = torch.stack(hs, dim=2)  # [2, B, L, H] float32
            x = torch.cat([hs[0], flip_padded(hs[1], lengths)], dim=-1)
        return x


LSTM_IMPLS = {"fused": FusedBiLSTM, "flax": BiLSTM}


class PairBiLSTMEncoder(nn.Module):
    """Sentence-pair encoder: a batch ``{"tokens1", "mask1", "tokens2",
    "mask2"}`` to the pair embedding [B, 8·d_hid] in float32. ``lstm_impl``:
    ``"fused"`` (:class:`FusedBiLSTM`) or ``"flax"`` (:class:`BiLSTM`)."""

    def __init__(self, vocab_size: int, d_word: int = 300, d_hid: int = 1500, n_layers: int = 2,
                 n_highway: int = 0, dropout: float = 0.2, dropout_embs: float = 0.2,
                 train_words: bool = False, embedding_table: np.ndarray | None = None,
                 lstm_impl: str = "fused", dtype: torch.dtype = torch.float32):
        super().__init__()
        if lstm_impl not in LSTM_IMPLS:
            raise ValueError(f"lstm_impl must be one of {sorted(LSTM_IMPLS)}, got {lstm_impl!r}")
        self.lstm_impl = lstm_impl
        self.dropout = dropout
        self.dropout_embs = dropout_embs
        self.train_words = train_words
        self.embedding_table = embedding_table
        self.dtype = dtype
        self.out_features = 8 * d_hid
        self.embed = nn.Embedding(vocab_size, d_word)
        self.highway = Highway(d_word, n_highway, dtype)
        self.bilstm = LSTM_IMPLS[lstm_impl](d_word, d_hid, n_layers, dtype)
        self.reset_parameters()
        self.requires_grad_(True)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The GloVe table when one was given, else normal(1.0) (Flax
        ``nn.Embed``'s ``normal(1.0)``); lecun-normal Dense and input
        kernels with zero biases; orthogonal recurrent gate blocks."""
        with torch.no_grad():
            if self.embedding_table is not None:
                self.embed.weight.copy_(torch.as_tensor(self.embedding_table))
            else:
                self.embed.weight.normal_(0.0, 1.0, generator=generator)
        self.highway.reset_parameters(generator)
        self.bilstm.reset_parameters(generator)

    def requires_grad_(self, requires_grad: bool = True) -> "PairBiLSTMEncoder":
        """As ``nn.Module.requires_grad_``, but frozen word embeddings
        (``train_words`` false, the GloVe default, ``models.py:25-31``)
        never require a gradient: the JAX package's ``stop_gradient``."""
        super().requires_grad_(requires_grad)
        self.embed.weight.requires_grad_(requires_grad and self.train_words)
        return self

    def encode(self, tokens: torch.Tensor, mask: torch.Tensor,
               generator=None, groups: int = 1) -> torch.Tensor:
        """Sentence encodings [N, 2·d_hid] in float32: embed, highway,
        dropout, BiLSTM, dropout, max-pool over the valid positions. The N
        rows are ``groups`` stacked batches (for the dropout draws)."""
        train = self.training
        embs = self.highway(self.embed(tokens))
        if train:
            embs = dropout(embs, self.dropout_embs, generator, groups)
        lengths = mask.sum(dim=1).to(torch.int64)
        enc = self.bilstm(embs.to(self.dtype), lengths)
        if train:
            enc = dropout(enc, self.dropout, generator, groups)
        # masked max-pool with a -inf fill, in float32 (models.py:159-163);
        # amax shares the gradient among tied maxima, as jnp.max does
        enc = torch.where(mask[..., None] > 0, enc.float(), -math.inf)
        return enc.amax(dim=1)

    def forward(self, batch: dict, generator=None) -> torch.Tensor:
        # both sentence columns run as one doubled batch; each column is
        # right-padded to the longer one (the added positions have mask 0,
        # so lengths and the max-pool do not change)
        steps = max(batch["tokens1"].shape[1], batch["tokens2"].shape[1])
        pad = lambda a: F.pad(a, (0, steps - a.shape[1]))  # noqa: E731
        tokens = torch.cat([pad(batch["tokens1"]), pad(batch["tokens2"])])
        mask = torch.cat([pad(batch["mask1"]), pad(batch["mask2"])])
        s1, s2 = self.encode(tokens, mask, generator, groups=2).chunk(2)
        return torch.cat([s1, s2, (s1 - s2).abs(), s1 * s2], dim=1)
