"""Losses, Adam, the global-norm clip, and the operand rounding of the
control run.

The rounding (``rounding`` of the networks) applies to the operands of
every matrix product and convolution and to the activations the
configuration stores in its type: ``None`` is the reference itself
(float32); ``"fp8"`` is the control, one step below the bfloat16 the
configurations state: float8 e4m3 with one scale a tensor (its largest
magnitude to 448, as fp8 training scales); ``"bf16"`` is the reference at
the configuration's own precision, which measures how far bfloat16 alone
moves a reading on the seed's inputs. The gradient passes straight
through the rounding."""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with a per-tensor scale; the gradient is
    passed straight through."""
    scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return t + (q - t.detach())


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` through bfloat16, the gradient passed straight through."""
    return t + (t.detach().to(torch.bfloat16).to(torch.float32) - t.detach())


def operand(t: torch.Tensor, rounding: str | None) -> torch.Tensor:
    if rounding is None:
        return t
    if rounding == "fp8":
        return round_fp8(t)
    if rounding == "bf16":
        return round_bf16(t)
    raise ValueError(f"unknown rounding {rounding!r}")


def set_full_precision() -> None:
    """Float32 products and convolutions in full precision (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def weighted_l1(pred, target, weight):
    """``mean(|pred - target| * weight)`` (``imdb-wiki-dir/loss.py``)."""
    return ((pred - target).abs() * weight).mean()


def weighted_mse(pred, target, weight):
    """``mean((pred - target)^2 * weight)`` (``sts-b-dir/loss.py``)."""
    return ((pred - target) ** 2 * weight).mean()


LOSSES = {"l1": weighted_l1, "mse": weighted_mse}


def clip_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """``g`` where the global norm is below ``max_norm``, else ``g / norm *
    max_norm`` (optax ``clip_by_global_norm``)."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()
    if norm < max_norm:
        return grads
    return [g / norm * max_norm for g in grads]


class Adam:
    """Adam without weight decay (Kingma and Ba, with the bias corrections
    of ``torch.optim.Adam``): ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 -
    b2) g^2``, ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) +
    eps)``."""

    def __init__(self, params: dict[str, torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / bc1)
