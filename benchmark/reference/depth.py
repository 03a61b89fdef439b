"""NYUD2-DIR dense depth regression in plain PyTorch, float32: the network
of Hu et al., *Revisiting Single Image Depth Estimation* (WACV 2019), as
``nyud2-dir/models/modules.py:6-174`` and ``net.py`` of the DIR code
(Yang et al., ICML 2021) ship it, and the recipe of ``nyud2-dir/train.py``
and ``loaddata.py``: per-pixel LDS weights, weighted MSE, Adam with L2, FDS
on the per-pixel rows of the last hidden map.

- E: the ResNet-50 encoder's four stage outputs (the blocks, batch norm
  and rounding of :mod:`reference.resnet`);
- D: a 1x1 convolution halving the 2048 channels, then four up-projections,
  to the third, second and first stage's resolution and to twice the first's;
- MFF: each stage's output up-projected to 16 channels at D's output size,
  concatenated, a 5x5 convolution;
- R: D's and MFF's maps concatenated (128 channels), two 5x5 convolutions
  (the FDS hook), the final 5x5 convolution to one channel with a bias.

An up-projection is ``relu(bn1_2(conv1_2(relu(bn1(conv1(u))))) +
bn2(conv2(u)))`` with ``u`` the bilinear resize of its input. Parameters
live in flat dicts keyed as the program's ``state_dict`` keys them.

Departures from the published code (each the program's too):

- the resize is ``F.interpolate(mode="bilinear", align_corners=False)``
  (the published ``F.upsample``). Every resize of this network is an
  upsample, where it equals ``jax.image.resize``'s, the program's
  (half-pixel centres, triangle weights, the edges clamped);
- batch norm folds the batch's biased variance with momentum 0.9 (Flax,
  :mod:`reference.resnet`), where torch folds the unbiased one;
- the paired geometric augmentation (scale, flip, rotation, crop) is left
  out: both sides get the crops. The photometric one (PCA lighting, then
  brightness, contrast and saturation, then ImageNet normalization,
  ``nyu_transform.py``) takes one draw a batch of each factor from the
  step's generator, as the program draws them, and applies the three
  jitters in this fixed order, where the published code draws per image
  and shuffles their order;
- the depth bucket is ``clamp(trunc(10 d), bucket_start, bucket_num - 1)``:
  the published FDS clamps from below only (``models/fds.py``), and would
  index past its tables at 10 m; the drawn depths stay under 10 m.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import convolve1d

from reference import fds as rfds
from reference import resnet as rresnet

# the NYUD2 train split's pixels in each 0.1-m bucket (loaddata.py:11-19)
TRAIN_BUCKET_NUM = [
    0, 0, 0, 0, 0, 0, 0, 25848691, 24732940, 53324326, 69112955, 54455432,
    95637682, 71403954, 117244217, 84813007, 126524456, 84486706, 133130272,
    95464874, 146051415, 146133612, 96561379, 138366677, 89680276, 127689043,
    81608990, 119121178, 74360607, 106839384, 97595765, 66718296, 90661239,
    53103021, 83340912, 51365604, 71262770, 42243737, 65860580, 38415940,
    53647559, 54038467, 28335524, 41485143, 32106001, 35936734, 23966211,
    32018765, 19297203, 31503743, 21681574, 16363187, 25743420, 12769509,
    17675327, 13147819, 15798560, 9547180, 14933200, 9663019, 12887283,
    11803562, 7656609, 11515700, 7756306, 9046228, 5114894, 8653419, 6859433,
    8001904, 6430700, 3305839, 6318461, 3486268, 5621065, 4030498, 3839488,
    3220208, 4483027, 2555777, 4685983, 3145082, 2951048, 2762369, 2367581,
    2546089, 2343867, 2481579, 1722140, 3018892, 2325197, 1952354, 2047038,
    1858707, 2052729, 1348558, 2487278, 1314198, 3338550, 1132666,
]
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PCA_EIGVAL = (0.2175, 0.0188, 0.0045)
PCA_EIGVEC = ((-0.5675, 0.7192, 0.4009),
              (-0.5808, -0.0045, -0.8140),
              (-0.5836, -0.6948, 0.4203))
LUMA = (0.299, 0.587, 0.114)  # the grayscale of torchvision, which nyu_transform.py copies


def _widths(stage_sizes, width: int, mff: int):
    """(the stages' channels, D's widths from its 1x1 convolution on, the
    hook's width)."""
    stages = [4 * width * 2 ** s for s in range(len(stage_sizes))]
    d = [stages[-1] // 2 ** (i + 1) for i in range(5)]
    return stages, d, d[-1] + 4 * mff


def layout(stage_sizes=(3, 4, 6, 3), width: int = 64, mff: int = 16):
    """The backbone's and the head's tensors, ``{name: (shape, init)}``:
    the encoder's as :func:`reference.resnet.layout` under ``encoder.``,
    He-normal fan-out convolutions, batch norm 1 and 0; the final
    convolution at the standard deviation of PyTorch's default for
    ``nn.Conv2d``, ``1 / sqrt(3 fan_in)``, which the published ``R`` module
    leaves it at, so that the first predictions lie near 0 m."""
    enc, _ = rresnet.layout(stage_sizes, width)
    back = {f"encoder.{k}": v for k, v in enc.items()}

    def conv(name, cin, cout, k):
        back[f"{name}.weight"] = ((cout, cin, k, k), ("normal", math.sqrt(2.0 / (cout * k * k))))

    def bn(name, c):
        for key, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            back[f"{name}.{key}"] = ((c,), ("const", value))

    def up(name, cin, cout):
        conv(f"{name}.conv1", cin, cout, 5)
        bn(f"{name}.bn1", cout)
        conv(f"{name}.conv1_2", cout, cout, 3)
        bn(f"{name}.bn1_2", cout)
        conv(f"{name}.conv2", cin, cout, 5)
        bn(f"{name}.bn2", cout)

    stages, d, hook = _widths(stage_sizes, width, mff)
    conv("d_conv", stages[-1], d[0], 1)
    bn("d_bn", d[0])
    for i in range(4):
        up(f"d_up.{i}", d[i], d[i + 1])
    for i, c in enumerate(stages):
        up(f"mff_up.{i}", c, mff)
    conv("mff_conv", 4 * mff, 4 * mff, 5)
    bn("mff_bn", 4 * mff)
    for i in range(2):
        conv(f"r_conv{i}", hook, hook, 5)
        bn(f"r_bn{i}", hook)
    head = {"conv.weight": ((1, hook, 5, 5), ("normal", 1.0 / math.sqrt(3 * hook * 25))),
            "conv.bias": ((1,), ("const", 0.0))}
    return back, head


class DepthRegressor(rresnet.ResNetRegressor):
    """Forward passes over the parameter dicts ``back`` (encoder, D, MFF,
    R's hidden convolutions) and ``head`` (R's last convolution, float32 as
    the configuration keeps it)."""

    def stages(self, x_nhwc: torch.Tensor, train: bool) -> list:
        """The encoder's four stage outputs, NCHW (the blocks of
        :meth:`reference.resnet.ResNetRegressor.encode`, which pools the last)."""
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.relu(self._bn(self._conv(x, "encoder.conv1", 2, 3), "encoder.bn1", train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        last = {f"layer{s + 1}.{n - 1}" for s, n in enumerate(self.stage_sizes)}
        out = []
        for p, cin, _, cout, stride in rresnet._blocks(self.stage_sizes, self.width):
            ends_stage = p in last
            p = f"encoder.{p}"
            y = F.relu(self._bn(self._conv(x, f"{p}.conv1", 1, 0), f"{p}.bn1", train))
            y = F.relu(self._bn(self._conv(y, f"{p}.conv2", stride, 1), f"{p}.bn2", train))
            y = self._bn(self._conv(y, f"{p}.conv3", 1, 0), f"{p}.bn3", train)
            if cin != cout or stride != 1:
                x = self._bn(self._conv(x, f"{p}.downsample.0", stride, 0),
                             f"{p}.downsample.1", train)
            x = F.relu(self._act(y + x))
            if ends_stage:
                out.append(x)
        return out

    def _up(self, x, name: str, size, train: bool):
        u = self._act(F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False))
        b1 = F.relu(self._bn(self._conv(u, f"{name}.conv1", 1, 2), f"{name}.bn1", train))
        b1 = self._bn(self._conv(b1, f"{name}.conv1_2", 1, 1), f"{name}.bn1_2", train)
        b2 = self._bn(self._conv(u, f"{name}.conv2", 1, 2), f"{name}.bn2", train)
        return F.relu(self._act(b1 + b2))

    def hook(self, x_nhwc: torch.Tensor, train: bool) -> torch.Tensor:
        """R's second hidden map, [N, H/2, W/2, 128] (NHWC): FDS's rows."""
        b = self.stages(x_nhwc, train)
        out_hw = (2 * b[0].shape[2], 2 * b[0].shape[3])
        d = F.relu(self._bn(self._conv(b[3], "d_conv", 1, 0), "d_bn", train))
        for i, size in enumerate((b[2].shape[2:], b[1].shape[2:], b[0].shape[2:], out_hw)):
            d = self._up(d, f"d_up.{i}", size, train)
        m = torch.cat([self._up(s, f"mff_up.{i}", out_hw, train) for i, s in enumerate(b)], 1)
        m = F.relu(self._bn(self._conv(m, "mff_conv", 1, 2), "mff_bn", train))
        r = torch.cat([d, m], 1)
        for i in range(2):
            r = F.relu(self._bn(self._conv(r, f"r_conv{i}", 1, 2), f"r_bn{i}", train))
        return r.permute(0, 2, 3, 1)

    def predict(self, hook: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(hook.permute(0, 3, 1, 2), self.head["conv.weight"], self.head["conv.bias"],
                     padding=2)
        return y.permute(0, 2, 3, 1)


def photometric(images_u8: torch.Tensor, gen: torch.Generator, lighting_std: float = 0.1,
                jitter: float = 0.4) -> torch.Tensor:
    """PCA lighting, brightness, contrast and saturation, then the ImageNet
    normalization of NHWC uint8 images; the draws, in the program's order:
    ``randn(n, 3)`` for the lighting, then ``rand(n)`` for each jitter."""
    dev, n = images_u8.device, images_u8.shape[0]
    const = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    alpha = torch.randn((n, 3), generator=gen, device=dev) * lighting_std
    factors = [(1 - jitter) + 2 * jitter * torch.rand((n, 1, 1, 1), generator=gen, device=dev)
               for _ in range(3)]
    x = images_u8.float() / 255.0
    x = x + (const(PCA_EIGVEC) * (alpha * const(PCA_EIGVAL))[:, None, :]).sum(-1)[:, None, None, :]
    x = x * factors[0]
    gray = lambda t: (t * const(LUMA)).sum(-1, keepdim=True)  # noqa: E731
    x = x * factors[1] + gray(x).mean(dim=(1, 2), keepdim=True) * (1 - factors[1])
    x = x * factors[2] + gray(x) * (1 - factors[2])
    return normalize(x)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of NHWC images in [0, 1] (or uint8)."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    dev = x.device
    return (x - torch.tensor(IMAGENET_MEAN, device=dev)) / torch.tensor(IMAGENET_STD, device=dev)


def depth_bins(depth: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``clamp(trunc(10 d), lo, hi)`` of every pixel, float32 products as
    ``get_bin_idx`` (``loaddata.py``) and the FDS module compute them."""
    return (depth.reshape(-1).float() * 10.0).to(torch.int32).clamp(lo, hi).long()


def lds_bucket_weights(reweight: str, ks: int, sigma: float, bucket_start: int,
                       bucket_num: int = 100) -> np.ndarray:
    """The per-bucket LDS weights of ``_get_bucket_weights``
    (``loaddata.py:29-53``) with LDS on: the counts from ``bucket_start``
    on (square-rooted for ``sqrt_inv``), convolved in reflect mode in their
    own type (integer counts stay integer), the first smoothed value
    repeated below ``bucket_start``, scaled so the weighted pixel count is
    the raw one; float64."""
    counts = TRAIN_BUCKET_NUM[bucket_start:]
    value = np.sqrt(counts) if reweight == "sqrt_inv" else np.asarray(counts)
    smoothed = convolve1d(value, weights=rfds.lds_window(ks, sigma), mode="reflect")
    smoothed = [smoothed[0]] * bucket_start + list(smoothed)
    scaling = np.sum(TRAIN_BUCKET_NUM) / np.sum(np.array(TRAIN_BUCKET_NUM) / np.array(smoothed))
    return np.asarray([scaling / smoothed[b] for b in range(bucket_num)])


def pixel_weights(depth: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """Each pixel's weight, ``table[min(trunc(10 d), 99)]`` (``_get_weights``),
    in ``depth``'s shape, float32."""
    t = torch.as_tensor(table, dtype=torch.float64, device=depth.device)
    return t[depth_bins(depth, 0, len(table) - 1)].float().view(depth.shape)


def weighted_mse(pred, depth, weight):
    """``mean((pred - depth)^2 * weight)`` over every pixel (``train.py``)."""
    return ((pred - depth) ** 2 * weight).mean()


class DepthFDS(rfds.FDS):
    """FDS over the per-pixel rows of the hook (``nyud2-dir/models/fds.py``):
    each pixel's bucket from its depth, every pixel eligible, no imputation
    of the buckets a pass leaves empty; calibration ``(x - m1) * sqrt(clip(v2
    / v1)) + m2`` where ``v1 > 0`` and ``v2 >= 0``, for buckets whose ``v1``
    sums to at least 1e-10 (``calibrate_mean_var``, ``util.py``)."""

    def _buckets(self, depth: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        return depth_bins(depth, c.bucket_start, c.bucket_num - 1) - c.bucket_start

    def _groups(self, labels: torch.Tensor):
        bucket = self._buckets(labels)
        for b in torch.unique(bucket).tolist():
            yield b, bucket == b

    def smooth(self, features: torch.Tensor, labels: torch.Tensor, epoch: int) -> torch.Tensor:
        c = self.cfg
        if epoch < c.start_smooth:
            return features
        bucket = self._buckets(labels)
        m1, v1 = self.mean_last[bucket], self.var_last[bucket]
        m2, v2 = self.smoothed_mean[bucket], self.smoothed_var[bucket]
        col = (v1 > 0.0) & (v2 >= 0.0)
        factor = torch.clamp(v2 / torch.where(col, v1, torch.ones_like(v1)), c.clip_min, c.clip_max)
        row = self.var_last.sum(1)[bucket] >= 1e-10
        out = (features - m1) * torch.sqrt(factor) + m2
        return torch.where(col & row[:, None], out, features)


def depth_fds(recipe: dict, feature_dim: int, device) -> DepthFDS:
    """The recipe's FDS module for NYUD2 (clip 0.2-5.0, guard positive)."""
    return DepthFDS(rfds.FDSConfig(
        feature_dim=feature_dim, bucket_num=recipe["bucket_num"],
        bucket_start=recipe["bucket_start"], start_update=recipe["start_update"],
        start_smooth=recipe["start_smooth"], ks=recipe["fds_ks"], sigma=recipe["fds_sigma"],
        momentum=recipe["fds_mmt"], grouping="depth", clip_min=0.2, clip_max=5.0,
        guard="positive"), device)


def with_l2(grads: dict, params: dict, weight_decay: float) -> dict:
    """``g + wd * p`` for every leaf: torch Adam's ``weight_decay``, the L2
    of ``train.py``'s optimizer."""
    return {k: g + weight_decay * params[k].detach() for k, g in grads.items()}


def rows_of(hook: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] → [N*H*W, C]."""
    return hook.reshape(-1, hook.shape[-1])

