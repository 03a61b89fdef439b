"""NYUD2 depth encoder-decoder on PyTorch.

The same network as the JAX package's ``models/depth_encdec.py`` (reference
``nyud2-dir/models/modules.py:6-174``, ``net.py:5-22``): the ResNet-50
encoder exposing its four stage outputs → decoder ``D`` (a 1x1 conv halving
the channels + four :class:`UpProjection` blocks, up to twice the stage-1
resolution) → multi-scale fusion ``MFF`` (each stage upsampled to the
decoder's resolution with 16 channels, concatenated, fused by a 5x5 conv) →
regression trunk ``R`` (two 5x5 conv+BN+ReLU on the 128-channel
concatenation). FDS calibrates the trunk's 128-channel map per pixel, before
the final 5x5 conv (:class:`DepthHead`), the reference's hook
(``modules.py:163-169``).

Numerics and layout, as in :mod:`models.resnet`:

- the public input is NHWC; inside, the network runs NCHW in the
  channels_last memory format, under bf16 autocast with float32 parameters
  and batch-norm statistics (Flax ``dtype=bf16, param_dtype=f32``);
- the hook is returned as a logical NHWC float32 tensor: a permuted view of
  the channels_last map, so its per-pixel rows are contiguous and line up
  with the ``[N, H, W, 1]`` targets in the JAX package's order with no copy;
- the bilinear resize is ``jax.image.resize(method="bilinear")``'s: two
  products with weight matrices (half-pixel centres, triangle kernel) cast
  to the map's dtype, so a bf16 map is resized in bf16 with float32
  accumulation, as in the JAX model, and its gradient is the transposed
  products, rounded once per product. (``F.interpolate`` would run in
  float32 under CUDA autocast, and its bf16 backward adds into the input
  gradient with bf16 atomics, ~870 adds per input pixel at 8x10 →
  114x152.)
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from imbalanced_regression_tpu_torch.models.resnet import (
    BatchNorm,
    Bottleneck,
    ResNetBackbone,
    _conv,
    _he_normal_fan_out,
)


def _resize_weights(n_in: int, n_out: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`_resize_weights_uncached`, made once per shape, dtype and
    device. A trace (``torch.export``, ``torch.compile``) makes its own and
    leaves the cache alone: its tensors are the tracer's placeholders, which
    an eager call after it must not find there."""
    if torch.compiler.is_compiling():
        return _resize_weights_uncached(n_in, n_out, dtype, device)
    return _resize_weights_cached(n_in, n_out, dtype, device)


def _resize_weights_uncached(n_in: int, n_out: int, dtype: torch.dtype,
                             device: torch.device) -> torch.Tensor:
    """[n_out, n_in] bilinear weights of ``jax.image.resize`` along one axis
    (``jax._src.image.scale.compute_weight_mat`` with its default
    antialiasing, in float32), cast to ``dtype``: half-pixel centres, the
    triangle kernel widened by the downscale factor, each output's weights
    normalized to sum to 1. (Every sample lies inside [-0.5, n_in - 0.5],
    so JAX's masks for samples outside the input never apply.)"""
    inv_scale = torch.tensor(n_in / n_out, dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=torch.float32)[None, :]).abs()
    w = (1.0 - x / torch.clamp(inv_scale, min=1.0)).clamp(min=0.0)
    return (w / w.sum(1, keepdim=True)).to(device=device, dtype=dtype)


_resize_weights_cached = functools.cache(_resize_weights_uncached)


def _resize_bilinear(x: torch.Tensor, size_hw) -> torch.Tensor:
    """``jax.image.resize(bilinear)`` of ``x`` [N, C, h, w] to ``size_hw``, in
    ``x``'s own dtype with autocast off: along the width, then the height,
    each a product with float32 accumulation rounded to the dtype. Returns
    [N, C, H, W] in the channels_last layout."""
    n, c, h, w = x.shape
    out_h, out_w = size_hw
    with torch.autocast(device_type=x.device.type, enabled=False):
        cols = _resize_weights(w, out_w, x.dtype, x.device)  # [W, w]
        rows = _resize_weights(h, out_h, x.dtype, x.device)  # [H, h]
        t = torch.matmul(cols, x.permute(0, 2, 3, 1))  # [N, h, W, C]
        y = torch.matmul(rows, t.reshape(n, h, out_w * c))  # [N, H, W * C]
    return y.view(n, out_h, out_w, c).permute(0, 3, 1, 2)


class UpProjection(nn.Module):
    """Bilinear upsample + two-branch conv block (``modules.py:6-31``):
    ``relu(bn1_2(conv1_2(relu(bn1(conv1(x))))) + bn2(conv2(x)))``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = _conv(in_features, features, 5)
        self.bn1 = BatchNorm(features)
        self.conv1_2 = _conv(features, features, 3)
        self.bn1_2 = BatchNorm(features)
        self.conv2 = _conv(in_features, features, 5)
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor, size_hw) -> torch.Tensor:
        x = _resize_bilinear(x, size_hw)
        branch1 = F.relu(self.bn1(self.conv1(x)))
        branch1 = self.bn1_2(self.conv1_2(branch1))
        branch2 = self.bn2(self.conv2(x))
        return F.relu(branch1 + branch2)


class DepthEncoderDecoder(nn.Module):
    """E → D → MFF → R-trunk; returns the per-pixel feature map [N, H/2, W/2,
    C] (NHWC, float32), the FDS hook. The final 5x5 conv is
    :class:`DepthHead`.

    ``mff_features`` (reference 16) and ``decoder_min_features`` (0 = the
    reference widths; otherwise a floor on every decoder stage's channels)
    are the JAX package's channel knobs; they change the hook width as
    :func:`depth_feature_dim` says."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 mff_features: int = 16, decoder_min_features: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResNetBackbone(stage_sizes, width, return_features=True, dtype=dtype)
        stage_ch = [width * 2**s * Bottleneck.expansion for s in range(4)]
        w = lambda n: max(n, decoder_min_features)  # noqa: E731
        nf = stage_ch[3] // 2
        # decoder D (modules.py:61-94)
        self.d_conv = _conv(stage_ch[3], w(nf), 1)
        self.d_bn = BatchNorm(w(nf))
        widths = [w(nf), w(nf // 2), w(nf // 4), w(nf // 8), w(nf // 16)]
        self.d_up = nn.ModuleList(UpProjection(a, b) for a, b in zip(widths, widths[1:]))
        # multi-scale fusion MFF (modules.py:96-128)
        self.mff_up = nn.ModuleList(UpProjection(c, mff_features) for c in stage_ch)
        m = 4 * mff_features
        self.mff_conv = _conv(m, m, 5)
        self.mff_bn = BatchNorm(m)
        # R trunk (modules.py:131-162)
        nr = widths[-1] + m
        self.r_conv0 = _conv(nr, nr, 5)
        self.r_bn0 = BatchNorm(nr)
        self.r_conv1 = _conv(nr, nr, 5)
        self.r_bn1 = BatchNorm(nr)
        self.out_features = nr
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """He-normal fan-out convolutions, BN γ=1 β=0 (the JAX package's
        ``conv_kernel_init``)."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                _he_normal_fan_out(mod.weight, generator)
            elif isinstance(mod, BatchNorm):
                mod.reset_parameters()

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        # ``generator``: unused (no dropout); the Trainer passes it to every backbone
        b1, b2, b3, b4 = self.encoder(x)
        autocast = (torch.autocast(device_type=b1.device.type, dtype=self.dtype)
                    if self.dtype != torch.float32 else contextlib.nullcontext())
        with autocast:
            d = F.relu(self.d_bn(self.d_conv(b4)))
            out_hw = (b1.shape[2] * 2, b1.shape[3] * 2)
            for up, size in zip(self.d_up, (b3.shape[2:], b2.shape[2:], b1.shape[2:], out_hw)):
                d = up(d, size)
            m = torch.cat([up(b, out_hw) for up, b in zip(self.mff_up, (b1, b2, b3, b4))], dim=1)
            m = F.relu(self.mff_bn(self.mff_conv(m)))
            r = torch.cat([d, m], dim=1)
            r = F.relu(self.r_bn0(self.r_conv0(r)))
            r = F.relu(self.r_bn1(self.r_conv1(r)))
        # the channels_last map seen as NHWC: a view, contiguous
        return r.to(torch.float32).permute(0, 2, 3, 1)


class DepthHead(nn.Module):
    """Final 5x5 conv → 1 channel, with bias, in float32
    (``modules.py:145,169``). Takes and returns NHWC; the ``generator``
    argument keeps the trainer's head call signature (the head draws
    nothing)."""

    def __init__(self, in_features: int = 128):
        super().__init__()
        self.conv = nn.Conv2d(in_features, 1, 5, padding=2, bias=True)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _he_normal_fan_out(self.conv.weight, generator)
        with torch.no_grad():
            self.conv.bias.zero_()

    def forward(self, features: torch.Tensor, generator: torch.Generator | None = None):
        y = self.conv(features.to(torch.float32).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)


def depth_feature_dim(num_features: int = 2048, mff_features: int = 16,
                      decoder_min_features: int = 0) -> int:
    """64 + block4_channels // 32 == 128 for ResNet-50 (``modules.py:136``);
    with the channel knobs, 4 * mff + max(num_features // 32,
    decoder_min_features)."""
    return 4 * mff_features + max(num_features // 32, decoder_min_features)
