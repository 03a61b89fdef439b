"""ResNet backbone + linear regression head on PyTorch.

The same network as the JAX package's ``models/resnet.py`` (v1.5 bottleneck
with the stride on the 3x3 conv, 7x7/2 stem, [3,4,6,3] blocks, global average
pool → 2048-d encoding → Linear(2048, 1)), with the same init (He-normal
fan-out convs, BN γ=1 β=0, lecun-normal head) and the same numerics:

- the public input is NHWC, as in JAX; inside, the network runs NCHW in the
  channels_last memory format (a permuted NHWC tensor already has that
  layout, so the permute moves no data);
- with ``dtype=torch.bfloat16`` the convolutions run under bf16 autocast
  while parameters and batch-norm statistics stay float32, as
  ``dtype=bf16, param_dtype=f32`` does in Flax; the pooled encoding is
  returned in float32;
- batch norm follows Flax: ``momentum=0.9`` on the running average (0.1 in
  torch's convention), epsilon 1e-5, and the running variance is updated
  with the *biased* batch variance (torch's ``nn.BatchNorm2d`` uses the
  unbiased one).

The FDS hook point is the boundary between :class:`ResNetBackbone` (returns
the pooled encoding) and :class:`RegressionHead`: the trainer calibrates
encodings between the two, where the reference calls ``self.FDS.smooth``
before ``self.linear`` (``imdb-wiki-dir/resnet.py:140-148``).

The family: bottleneck ResNet-50/101/152 (:class:`ResNetBackbone`) and the
BasicBlock ResNet-18/34 (:class:`ResNetBasicBackbone`, 512-d encoding), with
the JAX package's ``remat`` modes per residual block:

- ``"block"``: ``torch.utils.checkpoint`` (non-reentrant) keeps only the
  block's input and recomputes the whole block in the backward pass;
- ``"conv_outs"``: a selective checkpoint that saves the convolution outputs
  and recomputes batch norm and ReLU (JAX's ``save_only_these_names``
  policy on the tagged conv outputs).

The recompute runs each ``BatchNorm.forward`` a second time; it normalizes
with the batch statistics as before but leaves the running buffers alone, so
a remat step folds each batch into them once, as a plain step does.

Under a data-parallel mesh of more than one rank (:func:`use_global_batch_norm`),
training-mode batch norm normalizes with the *global* batch's mean and
biased variance, as GSPMD's sharded mean does in the JAX package, and its
backward reduces its two sums over the ranks too (:class:`_GlobalBatchNorm`).
A remat recompute runs those collectives again; every rank recomputes the
same blocks in the same order.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from imbalanced_regression_tpu_torch.parallel import mesh as dp

BN_MOMENTUM = 0.9  # Flax convention: running = 0.9 * running + 0.1 * batch
BN_EPS = 1e-5
REMAT_MODES = ("conv_outs", "block")

# set while a checkpointed block is recomputed: batch norm then leaves its
# running statistics as the block's first forward left them
_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    before = getattr(_recompute, "active", False)
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = before


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch norm of NCHW ``x`` over the global batch of a
    data-parallel mesh (equal rows a rank). Returns ``(out, mean, var)``,
    the statistics float32 and the variance biased.

    Forward: each rank's per-channel mean and biased variance, in float32
    (two passes over ``x``, so bf16 activations do not cancel as E[x^2] -
    E[x]^2 would), all-reduced in a zeroed [ranks, 2, C] buffer and
    combined exactly (Chan's formula for equal counts). Backward: the two
    sums of the input gradient, Σdy and Σdy·x̂, all-reduced in one buffer;
    the weight and bias gradients are this rank's sums (the trainer
    averages parameter gradients over the ranks). Only ``x`` and the
    statistics are kept for the backward, as ``native_batch_norm`` keeps."""

    @staticmethod
    def forward(ctx, x, weight, bias, mesh):
        c = x.shape[1]
        dims = [0, *range(2, x.ndim)]
        shape = [1, c] + [1] * (x.ndim - 2)
        xf = x.float()
        var_r, mean_r = torch.var_mean(xf, dim=dims, correction=0)
        stats = xf.new_zeros((mesh.world_size, 2, c))
        stats[mesh.rank, 0] = mean_r
        stats[mesh.rank, 1] = var_r
        means, variances = mesh.all_reduce(stats).unbind(1)
        mean = means.mean(0)
        var = (variances + (means - mean).square()).mean(0)
        invstd = torch.rsqrt(var + BN_EPS)
        out = (xf - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, grad_out, _grad_mean, _grad_var):
        x, weight, mean, invstd = ctx.saved_tensors
        mesh = ctx.mesh
        c = x.shape[1]
        dims = [0, *range(2, x.ndim)]
        shape = [1, c] + [1] * (x.ndim - 2)
        dy = grad_out.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * xhat).sum(dims)
        sums = mesh.all_reduce(torch.stack([sum_dy, sum_dy_xhat]))
        n = x.numel() // c * mesh.world_size
        dx = (dy - (sums[0] / n).view(shape) - xhat * (sums[1] / n).view(shape)) \
            * (invstd * weight).view(shape)
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None


class BatchNorm(nn.Module):
    """Batch norm over NCHW with Flax's running-statistics update.

    Training mode normalizes with the batch mean and biased variance and
    folds them into the running buffers as ``0.9 * running + 0.1 * batch``;
    eval mode normalizes with the running buffers. With ``mesh`` set to a
    mesh of more than one rank (:func:`use_global_batch_norm`), the batch is
    the global one (:class:`_GlobalBatchNorm`)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.mesh: dp.Mesh | None = None

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, BN_EPS)
        if self.mesh is not None and self.mesh.world_size > 1:
            out, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.mesh)
        else:
            # native_batch_norm returns the batch mean and 1/sqrt(var + eps) of
            # the biased variance it normalized with (float32 for bf16 input)
            out, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                        True, 0.0, BN_EPS)
            var = None
        if getattr(_recompute, "active", False):
            return out
        with torch.no_grad():
            if var is None:
                var = invstd.double().pow(-2).sub(BN_EPS).float()
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        return out


def use_global_batch_norm(module: nn.Module, mesh: dp.Mesh | None) -> None:
    """Make every :class:`BatchNorm` in ``module`` normalize over ``mesh``'s
    global batch in training mode (None: its own batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _he_normal_fan_out(w: torch.Tensor, generator: torch.Generator | None) -> None:
    """``normal(0, sqrt(2 / (k*k*out_channels)))`` (reference
    ``resnet.py:103-106``; Flax ``variance_scaling(2.0, 'fan_out', 'normal')``)."""
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator | None) -> None:
    """Flax's ``lecun_normal()`` into ``w`` in place: a normal truncated at
    two standard deviations, rescaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        # rejection-free truncation: inverse CDF of a uniform draw
        u = torch.empty_like(w).uniform_(generator=generator)
        lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
        w.copy_(torch.erfinv(lo + u * (hi - lo)) * math.sqrt(2.0) * std)


def dense_reset_(linear: nn.Linear, generator: torch.Generator | None) -> None:
    """Flax ``nn.Dense`` default: lecun-normal kernel (truncated normal at
    two standard deviations, rescaled to unit variance) and zero bias."""
    lecun_normal_(linear.weight, linear.weight.shape[1], generator)
    with torch.no_grad():
        linear.bias.zero_()


_CONV_OPS = (torch.ops.aten.convolution.default,)


def _save_conv_outs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="conv_outs"``: keep the
    convolution outputs, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _CONV_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(block: nn.Module, x: torch.Tensor, mode: str) -> torch.Tensor:
    """``block(x)`` under the ``mode`` checkpoint (see :data:`REMAT_MODES`).
    The first call of ``run`` is the forward; any later one is the
    backward's recompute, which must not update the BN running buffers."""
    calls = 0

    def run(inp):
        nonlocal calls
        calls += 1
        if calls == 1:
            return block(inp)
        with _recomputing():
            return block(inp)

    context = {}
    if mode == "conv_outs":
        context["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                  _save_conv_outs)
    return checkpoint(run, x, use_reentrant=False, **context)


def _check_remat(remat: str | None) -> None:
    if remat not in (None, *REMAT_MODES):
        raise ValueError(f"unknown remat mode {remat!r}; use one of {REMAT_MODES}")


class Bottleneck(nn.Module):
    """1x1 → 3x3(stride) → 1x1(x4) bottleneck, pre-activation-free (v1.5)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        out_features = features * self.expansion
        self.conv1 = _conv(in_features, features, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm(features)
        self.conv3 = _conv(features, out_features, 1)
        self.bn3 = BatchNorm(out_features)
        self.downsample = None
        if in_features != out_features or stride != 1:
            self.downsample = nn.Sequential(_conv(in_features, out_features, 1, stride),
                                            BatchNorm(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class BasicBlock(nn.Module):
    """3x3 → 3x3 basic residual block (ResNet-18/34, reference
    ``imdb-wiki-dir/resnet.py:14-38``); the downsample is a 1x1 conv + BN."""

    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_features, features, 3, stride)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm(features)
        self.downsample = None
        if in_features != features or stride != 1:
            self.downsample = nn.Sequential(_conv(in_features, features, 1, stride),
                                            BatchNorm(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetBackbone(nn.Module):
    """Stem + residual stages + global average pool → [N, 2048] encoding.

    Takes NHWC images. With ``return_features=True`` the per-stage feature
    maps (NCHW, channels_last) are returned instead (the NYUD2 ``E_resnet``
    encoder, ``nyud2-dir/models/modules.py:33-59``). ``remat`` checkpoints
    each residual block while gradients are on (see :data:`REMAT_MODES`)."""

    block_cls = Bottleneck

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 return_features: bool = False, dtype: torch.dtype = torch.bfloat16,
                 remat: str | None = None):
        super().__init__()
        _check_remat(remat)
        self.stage_sizes = tuple(stage_sizes)
        self.return_features = return_features
        self.dtype = dtype
        self.remat = remat
        self.conv1 = _conv(3, width, 7, 2)
        self.bn1 = BatchNorm(width)
        in_features = width
        for stage, num_blocks in enumerate(self.stage_sizes):
            blocks = []
            for block in range(num_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(self.block_cls(in_features, width * 2**stage, stride))
                in_features = width * 2**stage * self.block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_features = in_features
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _he_normal_fan_out(m.weight, generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        # ``generator``: unused (no dropout); the Trainer passes it to every backbone
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW view in channels_last layout
        autocast = (torch.autocast(device_type=x.device.type, dtype=self.dtype)
                    if self.dtype != torch.float32 else contextlib.nullcontext())
        with autocast:
            x = x.to(self.dtype)
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
            features = []
            for stage in range(len(self.stage_sizes)):
                for block in getattr(self, f"layer{stage + 1}"):
                    if self.remat and torch.is_grad_enabled():
                        x = _remat_block(block, x, self.remat)
                    else:
                        x = block(x)
                features.append(x)
            if self.return_features:
                return tuple(features)
            # global average pool == the reference's AvgPool2d(7) at 224x224
            encoding = x.mean(dim=(2, 3))
        return encoding.to(torch.float32)


class RegressionHead(nn.Module):
    """Final linear regressor; optional dropout like the reference's
    ``--dropout`` path (``imdb-wiki-dir/resnet.py:146-148``). Dropout draws
    from the generator passed to ``forward`` (a
    :class:`parallel.mesh.ShardedGenerator` under a mesh: this rank's rows
    of the global batch's draw)."""

    def __init__(self, in_features: int = 2048, out_dim: int = 1, dropout: float | None = None):
        super().__init__()
        self.dropout = dropout
        self.linear = nn.Linear(in_features, out_dim)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        dense_reset_(self.linear, generator)

    def forward(self, encoding: torch.Tensor, generator: torch.Generator | None = None):
        if self.dropout and self.training:
            keep = dp.rand(encoding.shape, generator, encoding.device) < 1.0 - self.dropout
            encoding = torch.where(keep, encoding / (1.0 - self.dropout),
                                   torch.zeros_like(encoding))
        return self.linear(encoding.to(torch.float32))


class ResNetBasicBackbone(ResNetBackbone):
    """BasicBlock variant (ResNet-18/34): the same stem, stages and pool with
    :class:`BasicBlock`, a ``width * 8``-d encoding (512 at width 64)."""

    block_cls = BasicBlock

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, remat: str | None = None):
        super().__init__(stage_sizes, width, dtype=dtype, remat=remat)


def resnet50_backbone(dtype: torch.dtype = torch.bfloat16,
                      remat: str | None = None) -> ResNetBackbone:
    return ResNetBackbone(stage_sizes=(3, 4, 6, 3), dtype=dtype, remat=remat)


def resnet101_backbone(dtype: torch.dtype = torch.bfloat16,
                      remat: str | None = None) -> ResNetBackbone:
    """Deep bottleneck variant (reference ``nyud2-dir/models/resnet.py:186-194``)."""
    return ResNetBackbone(stage_sizes=(3, 4, 23, 3), dtype=dtype, remat=remat)


def resnet152_backbone(dtype: torch.dtype = torch.bfloat16,
                      remat: str | None = None) -> ResNetBackbone:
    """Deepest bottleneck variant (reference ``nyud2-dir/models/resnet.py:197-205``)."""
    return ResNetBackbone(stage_sizes=(3, 8, 36, 3), dtype=dtype, remat=remat)


def resnet18_backbone(dtype: torch.dtype = torch.bfloat16,
                      remat: str | None = None) -> ResNetBasicBackbone:
    return ResNetBasicBackbone(stage_sizes=(2, 2, 2, 2), dtype=dtype, remat=remat)


def resnet34_backbone(dtype: torch.dtype = torch.bfloat16,
                      remat: str | None = None) -> ResNetBasicBackbone:
    """BasicBlock variant at ResNet-50 depth (``nyud2-dir/models/resnet.py:164-172``)."""
    return ResNetBasicBackbone(stage_sizes=(3, 4, 6, 3), dtype=dtype, remat=remat)
