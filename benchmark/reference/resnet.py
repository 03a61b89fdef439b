"""ResNet-50 regression network in plain PyTorch, float32 (He et al.
2016, v1.5: the stride on the 3x3 convolution; the DIR age model of
``imdb-wiki-dir/resnet.py``: global average pool, 2048-d encoding, one
linear output).

Parameters live in flat dicts keyed as the program's ``state_dict`` keys
them, so the benchmark can hand one draw of weights to both sides. Batch
norm normalizes with the batch's biased variance in training and folds the
batch's mean and biased variance into the running statistics as ``0.9 *
running + 0.1 * batch`` (the Flax convention the configuration states), with
epsilon 1e-5."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.optim import operand

BN_MOMENTUM, BN_EPS = 0.9, 1e-5


def _blocks(stage_sizes, width):
    """(prefix, in, mid, out, stride) of every bottleneck block."""
    cin = width
    for s, n in enumerate(stage_sizes):
        mid = width * 2 ** s
        for b in range(n):
            yield f"layer{s + 1}.{b}", cin, mid, 4 * mid, (2 if s > 0 and b == 0 else 1)
            cin = 4 * mid


def layout(stage_sizes=(3, 4, 6, 3), width: int = 64):
    """The backbone's and the head's tensors: ``{name: (shape, init)}`` with
    ``init`` one of ``("normal", std)`` (He-normal fan-out convolutions,
    lecun-normal head), ``("const", value)``."""
    back = {}

    def conv(name, cin, cout, k):
        back[f"{name}.weight"] = ((cout, cin, k, k), ("normal", math.sqrt(2.0 / (cout * k * k))))

    def bn(name, c):
        back[f"{name}.weight"] = ((c,), ("const", 1.0))
        back[f"{name}.bias"] = ((c,), ("const", 0.0))
        back[f"{name}.running_mean"] = ((c,), ("const", 0.0))
        back[f"{name}.running_var"] = ((c,), ("const", 1.0))

    conv("conv1", 3, width, 7)
    bn("bn1", width)
    for p, cin, mid, cout, stride in _blocks(stage_sizes, width):
        conv(f"{p}.conv1", cin, mid, 1)
        bn(f"{p}.bn1", mid)
        conv(f"{p}.conv2", mid, mid, 3)
        bn(f"{p}.bn2", mid)
        conv(f"{p}.conv3", mid, cout, 1)
        bn(f"{p}.bn3", cout)
        if cin != cout or stride != 1:
            conv(f"{p}.downsample.0", cin, cout, 1)
            bn(f"{p}.downsample.1", cout)
    d = 4 * width * 2 ** (len(stage_sizes) - 1)
    head = {"linear.weight": ((1, d), ("normal", math.sqrt(1.0 / d))),
            "linear.bias": ((1,), ("const", 0.0))}
    return back, head


def is_buffer(name: str) -> bool:
    return name.endswith("running_mean") or name.endswith("running_var")


class ResNetRegressor:
    """Forward passes over the parameter dicts ``back`` and ``head``."""

    def __init__(self, back: dict, head: dict, stage_sizes=(3, 4, 6, 3), width: int = 64,
                 rounding: str | None = None):
        self.back, self.head = back, head
        self.stage_sizes, self.width, self.rounding = stage_sizes, width, rounding

    def _act(self, x):
        """An activation as the configuration stores it (the control rounds
        every activation, as bf16 autocast keeps every one in bf16)."""
        return operand(x, self.rounding)

    def _conv(self, x, name, stride, pad):
        w = operand(self.back[f"{name}.weight"], self.rounding)
        return self._act(F.conv2d(operand(x, self.rounding), w, stride=stride, padding=pad))

    def _bn(self, x, name, train):
        p = self.back
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        rm, rv = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        if not train:
            return self._act(F.batch_norm(x, rm, rv, w, b, False, 0.0, BN_EPS))
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            rm.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            rv.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        return self._act(F.batch_norm(x, None, None, w, b, True, 0.0, BN_EPS))

    def encode(self, x_nhwc: torch.Tensor, train: bool) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.relu(self._bn(self._conv(x, "conv1", 2, 3), "bn1", train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for p, cin, _, cout, stride in _blocks(self.stage_sizes, self.width):
            y = F.relu(self._bn(self._conv(x, f"{p}.conv1", 1, 0), f"{p}.bn1", train))
            y = F.relu(self._bn(self._conv(y, f"{p}.conv2", stride, 1), f"{p}.bn2", train))
            y = self._bn(self._conv(y, f"{p}.conv3", 1, 0), f"{p}.bn3", train)
            if cin != cout or stride != 1:
                x = self._bn(self._conv(x, f"{p}.downsample.0", stride, 0),
                             f"{p}.downsample.1", train)
            x = F.relu(self._act(y + x))
        return self._act(x.mean(dim=(2, 3)))

    def predict(self, encoding: torch.Tensor) -> torch.Tensor:
        w = operand(self.head["linear.weight"], self.rounding)
        return F.linear(operand(encoding, self.rounding), w, self.head["linear.bias"])


def crop_flip_normalize(images_u8: torch.Tensor, offs_y, offs_x, flips, padding: int = 16):
    """torchvision's RandomCrop(pad 16, zero fill) and RandomHorizontalFlip
    at the given offsets and flips, then Normalize(0.5, 0.5); NHWC uint8 in,
    float32 out."""
    n, h, w, _ = images_u8.shape
    x = images_u8.float() / 255.0
    padded = F.pad(x, (0, 0, padding, padding, padding, padding))
    out = torch.empty_like(x)
    for i in range(n):
        crop = padded[i, offs_y[i]:offs_y[i] + h, offs_x[i]:offs_x[i] + w]
        out[i] = crop.flip(1) if flips[i] else crop
    return (out - 0.5) / 0.5


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    return (images_u8.float() / 255.0 - 0.5) / 0.5
