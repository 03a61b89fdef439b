"""Inputs made from ``--seed``, the same for the program and the
reference: weights drawn on the device in one call, label multisets fixed by
the configuration and ordered by the seed."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def device_generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a run."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % 2 ** 63)


def draw_weights(layouts: list[dict], seed: int, device: torch.device) -> list[dict]:
    """Float32 tensors for each ``{name: (shape, init)}`` layout: one
    ``randn`` on the device for every normal leaf, cut and scaled, and the
    constants filled."""
    normal = [(i, name, shape, init[1]) for i, lay in enumerate(layouts)
              for name, (shape, init) in lay.items() if init[0] == "normal"]
    total = sum(int(np.prod(shape)) for _, _, shape, _ in normal)
    flat = torch.randn(total, generator=device_generator(seed, device, 1), device=device)
    out = [{} for _ in layouts]
    offset = 0
    for i, name, shape, std in normal:
        n = int(np.prod(shape))
        out[i][name] = flat[offset:offset + n].view(shape).mul_(std)
        offset += n
    for i, lay in enumerate(layouts):
        for name, (shape, init) in lay.items():
            if init[0] == "const":
                out[i][name] = torch.full(shape, float(init[1]), device=device)
    return [{k: lay[k] for k in layouts[i]} for i, lay in enumerate(out)]


def counts_from_law(law: np.ndarray, total: int) -> np.ndarray:
    """Integer counts summing to ``total`` in the proportions of ``law``
    (largest remainders): a fixed multiset, whatever the seed."""
    share = np.asarray(law, np.float64) / np.sum(law) * total
    counts = np.floor(share).astype(np.int64)
    counts[np.argsort(-(share - counts), kind="stable")[: total - counts.sum()]] += 1
    return counts


def uint8_images(n: int, size: int, seed: int, device: torch.device, stream: int,
                 chunk: int = 512, cells: int = 8, grain: float = 16.0) -> np.ndarray:
    """``n`` NHWC uint8 images drawn on the device and copied once to host
    memory: smooth colour fields (a random ``cells`` x ``cells`` image,
    bilinearly upsampled) with gaussian grain, so that images differ from
    one another as photographs do, where pure noise would make every
    image's encoding all but the same."""
    gen = device_generator(seed, device, stream)
    out = np.empty((n, size, size, 3), np.uint8)
    host = torch.from_numpy(out)
    for start in range(0, n, chunk):
        c = min(chunk, n - start)
        field = torch.rand((c, 3, cells, cells), generator=gen, device=device) * 255.0
        img = F.interpolate(field, size=(size, size), mode="bilinear", align_corners=False)
        img = img + grain * torch.randn(img.shape, generator=gen, device=device)
        host[start:start + c].copy_(img.clamp_(0, 255).round_().to(torch.uint8)
                                    .permute(0, 2, 3, 1))
    return out
