"""On-device image augmentation.

The reference augments on 32 CPU worker processes via torchvision
(``imdb-wiki-dir/datasets.py:38-53``: Resize → RandomCrop(pad 16) →
RandomHorizontalFlip → Normalize(.5, .5)). Here the random crop / flip /
normalize run on the device, on the whole batch at once (resize happens once
at load time).

Inputs are [N, H, W, C] (NHWC, as in the JAX package), either uint8 in
[0, 255] or float32 in [0, 1] (the ToTensor convention); output is float32
normalized to [-1, 1] like Normalize([.5,.5,.5], [.5,.5,.5]).

:func:`crop_flip_normalize` is the deterministic core: it takes the crop
offsets and flips as tensors, so a test can feed the same ones to the JAX
version. :func:`random_crop_flip_normalize` draws them from a
``torch.Generator`` on the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_unit_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → float32 [0,1] on the device (ship bytes to the card,
    cast there — 4x less host→device traffic than float32 upload)."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images.to(torch.float32)


def crop_flip_normalize(images: torch.Tensor, offs_y: torch.Tensor, offs_x: torch.Tensor,
                        flips: torch.Tensor, padding: int = 16) -> torch.Tensor:
    """Crop each image at (``offs_y[i]``, ``offs_x[i]``) from its zero-padded
    copy, mirror it horizontally where ``flips[i]``, then normalize.

    One gather over the batch: output pixel (y, x) of image i reads padded
    pixel (offs_y[i] + y, offs_x[i] + x'), with x' = W - 1 - x when
    flipped."""
    n, h, w, c = images.shape
    dev = images.device
    # zero padding, like torchvision RandomCrop's default (pad before the
    # float cast: a zero byte and a zero float are the same pixel)
    padded = F.pad(images, (0, 0, padding, padding, padding, padding))
    ys = offs_y.to(dev, torch.long)[:, None] + torch.arange(h, device=dev)  # [N, H]
    xr = torch.arange(w, device=dev)
    xr = torch.where(flips.to(dev, torch.bool)[:, None], w - 1 - xr, xr)  # [N, W]
    xs = offs_x.to(dev, torch.long)[:, None] + xr
    rows = torch.arange(n, device=dev)[:, None, None]
    cropped = padded[rows, ys[:, :, None], xs[:, None, :]]  # [N, H, W, C]
    return (to_unit_float(cropped) - 0.5) / 0.5


def random_crop_flip_normalize(images: torch.Tensor, generator: torch.Generator | None = None,
                               padding: int = 16) -> torch.Tensor:
    """Per-sample random crop from zero-padded images + horizontal flip +
    (-0.5)/0.5 normalization. The offsets and flips are drawn on the
    images' device from ``generator``."""
    n = images.shape[0]
    dev = images.device
    offs_y = torch.randint(0, 2 * padding + 1, (n,), generator=generator, device=dev)
    offs_x = torch.randint(0, 2 * padding + 1, (n,), generator=generator, device=dev)
    flips = torch.rand((n,), generator=generator, device=dev) < 0.5
    return crop_flip_normalize(images, offs_y, offs_x, flips, padding)


def normalize_only(images: torch.Tensor) -> torch.Tensor:
    """Eval-path transform: Normalize([.5]*3, [.5]*3) only."""
    return (to_unit_float(images) - 0.5) / 0.5
