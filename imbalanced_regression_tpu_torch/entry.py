"""Entry points of the port: the single-card flagship forward and the
multi-rank dry run, the counterparts of the JAX package's
``__graft_entry__.py``.

- :func:`entry` returns the eval forward of the flagship model (the
  ResNet-50 age regressor of IMDB-WIKI/AgeDB-DIR, bf16 compute on float32
  parameters, as ``__graft_entry__.py:53-70`` builds it) and its example
  arguments: a batch of 8 zero 224x224 NHWC images.
- :func:`dryrun_multichip` (from :mod:`parallel.dryrun`) runs one
  data-parallel train step, stats pass, padded eval and RRT step of every
  task family on ``n`` local ranks.

Both run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from imbalanced_regression_tpu_torch.models.resnet import RegressionHead, resnet50_backbone
from imbalanced_regression_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: F401
from imbalanced_regression_tpu_torch.train import resolve_device

BATCH, IMG = 8, 224


def forward(backbone: torch.nn.Module, head: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The eval forward: [N, 224, 224, 3] float32 images → [N, 1] float32."""
    with torch.no_grad():
        return head(backbone(x))


def entry(device: str | torch.device = "cuda"):
    """``(forward, (backbone, head, x))``: ``forward(*args)`` is the eval
    forward of ``resnet50_backbone(dtype=torch.bfloat16)`` and a
    ``RegressionHead`` on ``x``, an ``(8, 224, 224, 3)`` float32 batch of
    zeros. The weights are drawn from a ``torch.Generator`` seeded with 0
    (He-normal convolutions, a lecun-normal head, as the Flax initializers
    draw them); the modules are in eval mode on ``device``."""
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(0)
    backbone, head = resnet50_backbone(dtype=torch.bfloat16), RegressionHead()
    backbone.reset_parameters(generator)
    head.reset_parameters(generator)
    backbone.to(dev).eval()
    head.to(dev).eval()
    x = torch.zeros((BATCH, IMG, IMG, 3), dtype=torch.float32, device=dev)
    return forward, (backbone, head, x)
