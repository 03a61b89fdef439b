"""Single-device trainer: ``backbone -> fds_smooth -> head -> weighted loss
-> Adam``, with the epoch-end FDS stats pass.

The PyTorch counterpart of the JAX package's ``train.py``. What carries over:

- **FDS inside the step**: encodings are calibrated between backbone and head
  (where the reference calls ``FDS.smooth`` before the final linear); on the
  card this is the K1 kernel forward and K2 backward.
- **Epoch-end FDS stats pass as streaming moments**: per-batch bucket moments
  (K3 on the card) are accumulated on the device instead of gathering every
  encoding to the host. The pass runs the backbone in train mode (BN batch
  statistics update) under ``no_grad`` and over augmented inputs, matching
  the reference's ``model.train()`` + ``torch.no_grad()`` pass over the
  train loader (``imdb-wiki-dir/train.py:269-281``).
- **Update ordering preserved**: ``update_last_epoch_stats(epoch)`` *then*
  ``update_running_stats(..., epoch)`` — the stats snapshot used for
  smoothing during epoch e+1 excludes epoch e's features.
- **Per-epoch MultiStep lr**: ``lr * 0.1`` per passed milestone (NYUD2's
  ``lr * 0.1 ** (epoch // 5)`` is milestones every 5 epochs), set on the
  optimizer's param group before each step.
- **Loss weights**: ``weight_fn(batch)`` computes them on the device (NYUD2's
  per-pixel bucket-table lookup) and takes precedence over
  ``batch["weight"]``.
- **Dense hooks**: the FDS hook may be a per-pixel map [N, H, W, C]; the
  calibration and the stats pass take it as N·H·W rows.

The state is mutable: a step updates the modules, the optimizer and the
generator in place and returns the same :class:`TrainState`.

Not ported yet: SGD, gradient clipping, RRT head-only training
(``retrain_fc``), ``target_scale`` and the device-resident indexed mode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn as nn

from imbalanced_regression_tpu_torch.fds import (
    FDSConfig,
    FDSState,
    fds_apply_moments,
    fds_bucket_moments,
    fds_init,
    fds_smooth,
    fds_update_last_epoch_stats,
    fds_zero_moments,
)
from imbalanced_regression_tpu_torch.ops.losses import LOSS_REGISTRY

def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a run executes on: CUDA unless the caller asks for the
    CPU. Raises when CUDA is asked for (or implied) and there is no GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' (or --device cpu) "
                           "to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def set_numerics() -> None:
    """Float32 matmuls in full precision: FDS statistics and their one-hot
    contractions stay float32 (the H100 form of the JAX package's
    ``Precision.HIGHEST`` rule). cuDNN TF32 is off as well: the bf16
    backbone never runs a float32 convolution, and a float32 backbone (the
    parity runs) should match the reference's full-precision convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Optimization config mirroring the reference flags
    (``imdb-wiki-dir/train.py:49-66``): Adam with a per-epoch MultiStep lr;
    the age suites without weight decay, NYUD2 with L2 1e-4
    (``nyud2-dir/train.py:146``)."""

    loss: str = "l1"
    lr: float = 1e-3
    # torch-Adam L2: gradient += wd * param before the moments, as the JAX
    # package's optax.add_decayed_weights before adam
    adam_weight_decay: float = 0.0
    schedule: tuple[int, ...] = (60, 80)  # epochs at which lr drops 10x


@dataclasses.dataclass
class TrainState:
    step: int
    backbone: nn.Module
    head: nn.Module
    optimizer: torch.optim.Optimizer
    fds: FDSState | None
    generator: torch.Generator  # augmentation and dropout draws, on the device


class Trainer:
    """``backbone -> fds_smooth -> head -> weighted loss``: one train step,
    one eval step and the FDS stats pass."""

    def __init__(
        self,
        backbone: nn.Module,
        head: nn.Module,
        config: TrainerConfig,
        fds_config: FDSConfig | None = None,
        train_augment: Callable | None = None,
        eval_transform: Callable | None = None,
        weight_fn: Callable | None = None,
        device: str | torch.device | None = None,
    ):
        self.backbone = backbone
        self.head = head
        self.config = config
        self.fds_config = fds_config
        # on-device input transforms: train_augment(images, generator),
        # eval_transform(images); weight_fn(batch) computes the loss weights
        # on the device instead of batch["weight"]
        self.train_augment = train_augment
        self.eval_transform = eval_transform
        self.weight_fn = weight_fn
        self.device = resolve_device(device)
        set_numerics()
        self._loss_fn = LOSS_REGISTRY[config.loss]

    # ------------------------------------------------------------------ setup
    def init_state(self, seed: int = 0) -> TrainState:
        """Initialize the weights from ``seed`` (on the CPU, so the draw does
        not depend on the device), move the modules to the device and build
        the optimizer and the FDS state."""
        init_gen = torch.Generator().manual_seed(seed)
        self.backbone.reset_parameters(init_gen)
        self.head.reset_parameters(init_gen)
        backbone = self.backbone.to(self.device, memory_format=torch.channels_last)
        head = self.head.to(self.device)
        params = list(backbone.parameters()) + list(head.parameters())
        optimizer = torch.optim.Adam(params, lr=self.config.lr,
                                     weight_decay=self.config.adam_weight_decay)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        fds = fds_init(self.fds_config, self.device) if self.fds_config else None
        return TrainState(step=0, backbone=backbone, head=head, optimizer=optimizer, fds=fds,
                          generator=generator)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if k != "count"}

    # ------------------------------------------------------------------ steps
    def train_step(self, state: TrainState, batch: dict, epoch: int):
        """One optimization step. Returns (state, loss, predictions); loss
        and predictions stay on the device (no host sync)."""
        # per-epoch MultiStep lr (utils.py:81-86): lr * 0.1 per passed milestone
        lr = self.config.lr * 0.1 ** sum(epoch >= m for m in self.config.schedule)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        b = self._to_device(batch)
        state.backbone.train()
        state.head.train()
        x = b["input"]
        if self.train_augment is not None:
            x = self.train_augment(x, state.generator)
        encoding = state.backbone(x)
        if self.fds_config is not None:
            encoding = fds_smooth(self.fds_config, state.fds, encoding, b["target"], epoch,
                                  bucket_idx=b.get("bucket_idx"))
        pred = state.head(encoding, generator=state.generator)
        weights = self.weight_fn(b) if self.weight_fn is not None else b.get("weight")
        loss = self._loss_fn(pred, b["target"], weights)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), pred.detach()

    def train_epoch(self, state: TrainState, batches: Iterable[dict], epoch: int):
        """One epoch over host batches; returns (state, mean train loss).

        Losses stay on the device until the epoch ends; the loss-explosion
        guard (reference train.py:256) therefore fires at epoch granularity."""
        losses, counts = [], []
        for batch in batches:
            counts.append(len(batch["target"]))
            state, loss, _ = self.train_step(state, batch, epoch)
            losses.append(loss)
        if not losses:
            return state, 0.0
        losses = torch.stack(losses).cpu().numpy()  # single sync
        if np.any(~np.isfinite(losses)) or np.any(losses > 1e6):
            raise FloatingPointError(f"Loss explosion: max={losses.max()}")
        counts = np.asarray(counts)
        return state, float((losses * counts).sum() / counts.sum())

    @torch.no_grad()
    def fds_epoch_pass(self, state: TrainState, batches: Iterable[dict], epoch: int) -> TrainState:
        """Epoch-end FDS stats pass (streaming moments), preserving the
        reference's snapshot-then-update ordering."""
        cfg = self.fds_config
        if cfg is None or epoch < cfg.start_update:
            return state
        moments = fds_zero_moments(cfg, self.device)
        generator = torch.Generator(device=self.device).manual_seed(epoch)
        # train-mode backbone (BN batch stats update, like the reference's
        # model.train() + no_grad stats pass), pre-smooth encodings, over the
        # augmented train loader (imdb-wiki-dir/train.py:273)
        state.backbone.train()
        for batch in batches:
            b = self._to_device(batch)
            x = b["input"]
            if self.train_augment is not None:
                x = self.train_augment(x, generator)
            encoding = state.backbone(x)
            moments = moments + fds_bucket_moments(cfg, encoding, b["target"], b.get("bucket_idx"))
        fds = fds_update_last_epoch_stats(cfg, state.fds, epoch)
        state.fds = fds_apply_moments(cfg, fds, moments, epoch)
        return state

    @torch.no_grad()
    def predict_batch(self, state: TrainState, batch: dict, count: int | None = None) -> np.ndarray:
        """Predict one (possibly padded) eval batch; returns the first
        ``count`` rows on the host."""
        n = count if count is not None else len(batch["target"])
        b = self._to_device(batch)
        state.backbone.eval()
        state.head.eval()
        x = b["input"]
        if self.eval_transform is not None:
            x = self.eval_transform(x)
        pred = state.head(state.backbone(x))
        return pred.cpu().numpy()[:n]

    def predict(self, state: TrainState, batches: Iterable[dict]):
        """Gather predictions and targets on the host for metric computation."""
        preds, targets = [], []
        for batch in batches:
            n = batch.pop("count", len(batch["target"]))
            preds.append(self.predict_batch(state, batch, n))
            targets.append(np.asarray(batch["target"])[:n])
        return np.concatenate(preds), np.concatenate(targets)


def snapshot_state(state: TrainState) -> dict:
    """A copy of the weights, BN statistics and FDS state (the in-memory
    best model of ``--save_ckpt 0``)."""
    clone = lambda sd: {k: v.detach().clone() for k, v in sd.items()}  # noqa: E731
    return {"backbone": clone(state.backbone.state_dict()), "head": clone(state.head.state_dict()),
            "fds": state.fds}


def restore_state(state: TrainState, snapshot: dict) -> TrainState:
    state.backbone.load_state_dict(snapshot["backbone"])
    state.head.load_state_dict(snapshot["head"])
    state.fds = snapshot["fds"]
    return state
