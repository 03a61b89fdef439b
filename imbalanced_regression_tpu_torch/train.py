"""Trainer: ``backbone -> fds_smooth -> head -> weighted loss
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
- **Optimizers**: Adam (torch-style L2 ``adam_weight_decay``) or SGD with
  momentum and L2 ``weight_decay`` (``torch.optim.SGD`` with no dampening is
  optax's ``add_decayed_weights`` → ``sgd(momentum)`` at unit lr, scaled by
  the scheduled lr). Clipping by global norm (``clip_grad_norm``) follows
  optax's formula and runs before the optimizer, so before weight decay.
- **RRT** (``retrain_fc``, two-stage regressor re-training): the backbone's
  parameters stop requiring gradients and the optimizer holds the head's
  only (the JAX package's masked optimizer, ``imdb-wiki-dir/train.py:154-172``);
  the backbone stays in train mode, so its BN running statistics still
  update, and FDS still calibrates in the forward (K1), but with no gradient
  to carry back through the encoding the K2 backward never launches.
- **Mid-epoch resume**: ``train_epoch(start_step=k)`` takes a stream that
  starts at the epoch's step k (``batch_iterator(skip=k)`` leaves the first
  k batches out without gathering them, so a stream-mode image array never
  decodes them), and a ``step_hook`` sees the post-step state (drivers
  write checkpoints there); the device generator rides in the checkpoint,
  so a resumed epoch draws the uninterrupted run's augmentation.
- **Staged input**: ``train_epoch`` and ``fds_epoch_pass`` take their host
  batches through ``prefetch_batches`` (``data/streaming.py``), whose
  background thread gathers (decodes, pages in) and stages batch k+1 while
  step k runs. On CUDA the staging copies into pinned buffers and sends
  them on a side stream (``data/staging.py``); on the CPU it is
  ``_to_device``. ``train_step``, the eval path and the indexed mode copy
  in the calling thread.

- **Indexed mode** (STS-B): ``bind_device_data`` puts a whole (small)
  train split on the device once; ``train_step_indexed`` and
  ``fds_epoch_pass_indexed`` gather each batch there from one index
  vector, and are ``train_step`` / ``fds_epoch_pass`` on the gathered rows.
- **Dropout**: the backbone gets the state's generator in the step and the
  pass's generator in the stats pass, where it stays in train mode (the
  STS-B encoder's dropout stays live there, ``sts-b-dir/trainer.py:158-166``);
  the ResNet and depth backbones ignore it.

- **Data parallelism** (``mesh=``, :mod:`parallel.mesh`; the JAX
  Trainer's ``mesh``): each rank runs this trainer on its contiguous rows
  of every global batch (host batches, index batches and padded eval
  batches alike) with a replicated state. Batch norm normalizes over the
  global batch; after ``loss.backward()`` the gradients are averaged over
  the ranks in one all-reduce, before the global-norm clip, so the clip
  sees the global norm as ``optax`` does; the stats pass all-reduces its
  moments once a pass; augmentation and dropout draw at the global
  batch's shape and keep the rank's rows; the epoch loss is the global
  mean; ``predict_batch`` gathers every rank's predictions on every rank.
  The K1-K3 kernels run on each rank's rows. ``mesh=None`` is the
  one-process path.

Batches may be nested dicts (STS-B's ``input`` holds four arrays).

The state is mutable: a step updates the modules, the optimizer and the
generator in place and returns the same :class:`TrainState`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterable, Iterator

import numpy as np
import torch
import torch.nn as nn

from imbalanced_regression_tpu_torch.data.batching import tree_map
from imbalanced_regression_tpu_torch.data.staging import PinnedStager, StagedBatch
from imbalanced_regression_tpu_torch.data.streaming import prefetch_batches
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
from imbalanced_regression_tpu_torch.models.resnet import use_global_batch_norm
from imbalanced_regression_tpu_torch.ops.losses import LOSS_REGISTRY
from imbalanced_regression_tpu_torch.ops.moments import all_reduce_moments
from imbalanced_regression_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from imbalanced_regression_tpu_torch.utils.logging_tools import recorder


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
    (``imdb-wiki-dir/train.py:49-66``) and the JAX package's
    ``TrainerConfig``: Adam or SGD with a per-epoch MultiStep lr; the age
    suites' Adam without weight decay, NYUD2's with L2 1e-4
    (``nyud2-dir/train.py:146``)."""

    loss: str = "l1"
    optimizer: str = "adam"  # 'adam' | 'sgd'
    lr: float = 1e-3
    momentum: float = 0.9  # SGD
    weight_decay: float = 1e-4  # SGD's L2
    # torch-Adam L2: gradient += wd * param before the moments, as the JAX
    # package's optax.add_decayed_weights before adam
    adam_weight_decay: float = 0.0
    schedule: tuple[int, ...] = (60, 80)  # epochs at which lr drops 10x
    epochs: int = 90
    retrain_fc: bool = False
    clip_grad_norm: float | None = None  # STS uses 5.0 (trainer.py:40)
    huber_beta: float = 1.0
    target_scale: float = 1.0  # STS computes loss on target/5 (models.py:101-107)

    def loss_fn(self) -> Callable:
        fn = LOSS_REGISTRY[self.loss]
        if self.loss == "huber":
            beta = self.huber_beta
            return lambda p, t, w: fn(p, t, w, beta=beta)
        return fn


@dataclasses.dataclass
class TrainState:
    step: int
    backbone: nn.Module
    head: nn.Module
    optimizer: torch.optim.Optimizer
    fds: FDSState | None
    generator: torch.Generator  # augmentation and dropout draws, on the device
    mesh: Mesh | None = None  # the data-parallel mesh the state is replicated on


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
        mesh: Mesh | None = None,
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
        # data parallelism: this rank's device is the mesh's
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        if (mesh is not None and device is not None
                and resolve_device(device).type != mesh.device.type):
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        use_global_batch_norm(backbone, mesh)
        set_numerics()
        if config.optimizer not in ("adam", "sgd"):
            raise ValueError(f"optimizer must be 'adam' or 'sgd', got {config.optimizer!r}")
        self._loss_fn = config.loss_fn()
        self._bound_data: dict | None = None
        self._copy_stream: torch.cuda.Stream | None = None  # side stream of the staged copies
        # spans (utils.logging_tools.recorder): this trainer's number, and
        # the epoch it last stepped or passed in, which its predictions carry
        self.trace_id = recorder.new_trainer(self.device)
        self._epoch = -1

    def _span(self, name: str, epoch: int | None = None, rows: int = -1):
        return recorder.span(name, self.trace_id, self._epoch if epoch is None else epoch, rows)

    # ------------------------------------------------------------------ setup
    def init_state(self, seed: int = 0) -> TrainState:
        """Initialize the weights from ``seed`` (on the CPU, so the draw does
        not depend on the device), move the modules to the device and build
        the optimizer and the FDS state. Under ``retrain_fc`` the backbone is
        frozen and the optimizer holds the head's parameters only; a
        parameter the backbone keeps frozen itself (the STS-B encoder's word
        embeddings) is left out of it too. ``channels_last`` applies to the
        4-d (convolution) parameters only."""
        cfg = self.config
        init_gen = torch.Generator().manual_seed(seed)
        self.backbone.reset_parameters(init_gen)
        self.head.reset_parameters(init_gen)
        backbone = self.backbone.to(self.device, memory_format=torch.channels_last)
        head = self.head.to(self.device)
        backbone.requires_grad_(not cfg.retrain_fc)
        params = list(head.parameters())
        if not cfg.retrain_fc:
            params = [p for p in backbone.parameters() if p.requires_grad] + params
        if cfg.optimizer == "sgd":
            optimizer = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                                        weight_decay=cfg.weight_decay, dampening=0.0)
        else:
            optimizer = torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.adam_weight_decay)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        fds = fds_init(self.fds_config, self.device) if self.fds_config else None
        state = TrainState(step=0, backbone=backbone, head=head, optimizer=optimizer, fds=fds,
                           generator=generator, mesh=self.mesh)
        if self.mesh is not None:
            # every rank seeded the same; the broadcast guards that
            replicate(self.mesh, state)
        return state

    def _to_device(self, batch: dict) -> dict:
        return tree_map(lambda v: torch.as_tensor(v).to(self.device, non_blocking=True),
                        {k: v for k, v in batch.items() if k != "count"})

    def _local(self, batch: dict) -> dict:
        """This rank's rows of a global host batch (the batch itself
        without a mesh)."""
        if self.mesh is None:
            return batch
        return shard_batch(self.mesh, {k: v for k, v in batch.items() if k != "count"})

    def _draws(self, generator: torch.Generator):
        """The generator as the random draws of a step see it: under a
        mesh, one that draws at the global batch's shape and keeps this
        rank's rows."""
        return generator if self.mesh is None else self.mesh.sharded(generator)

    def rank_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks (``t`` without a mesh): the
        global batch's mean loss from each rank's."""
        return t if self.mesh is None else self.mesh.mean(t)

    def all_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's rows of ``t`` along ``dim``, in rank order (``t``
        without a mesh): the global batch's predictions from each rank's."""
        return t if self.mesh is None else self.mesh.gather_rows(t, dim)

    def _device_batches(self, batches: Iterable[dict]) -> Iterator[dict]:
        """``batches`` on the device, staged by ``prefetch_batches``' thread
        one or two batches ahead: on CUDA through pinned buffers on the side
        stream (:class:`PinnedStager`; the current stream waits on each
        batch's copy), on the CPU by ``_to_device``. Closing this generator
        stops the thread. Each batch's wait (taking it from the thread, and
        the current stream's wait on its copy) is an ``input_wait`` span of
        the epoch the trainer is in."""
        if self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            stage_batch, ready = PinnedStager(self.device, self._copy_stream), StagedBatch.wait
        else:
            stage_batch, ready = self._to_device, lambda b: b
        transform = stage_batch if self.mesh is None else lambda b: stage_batch(self._local(b))
        with contextlib.closing(prefetch_batches(batches, transform=transform)) as staged:
            while True:
                with self._span("input_wait") as span:
                    batch = next(staged, None)
                    if batch is None:
                        span.drop()
                        return
                    batch = ready(batch)
                    span.rows = len(batch["target"])
                yield batch

    # ---------------------------------------------------- device-resident data
    def bind_device_data(self, data: dict) -> None:
        """Put a (small) dataset on the device once, for
        :meth:`train_step_indexed` and :meth:`fds_epoch_pass_indexed` to
        gather their batches from (the STS-B-DIR train split is ~2 MB).
        Under a mesh every rank holds the whole split and gathers its rows
        of each index batch."""
        self._bound_data = self._to_device(data)

    def _gather(self, idx, epoch: int) -> dict:
        assert self._bound_data is not None, "call bind_device_data first"
        with self._span("gather", epoch, len(idx)):
            if self.mesh is not None:
                idx = shard_batch(self.mesh, np.asarray(idx))
            idx = torch.as_tensor(np.asarray(idx, np.int64)).to(self.device, non_blocking=True)
            return tree_map(lambda a: a.index_select(0, idx), self._bound_data)

    # ------------------------------------------------------------------ steps
    def train_step(self, state: TrainState, batch: dict, epoch: int):
        """One optimization step. Returns (state, loss, predictions); loss
        and predictions stay on the device (no host sync). Under a mesh they
        are this rank's (:meth:`rank_mean`, :meth:`all_rows` combine
        them)."""
        return self._step(state, self._to_device(self._local(batch)), epoch)

    def train_step_indexed(self, state: TrainState, idx, epoch: int):
        """:meth:`train_step` on rows ``idx`` of the :meth:`bind_device_data`
        data, gathered on the device."""
        return self._step(state, self._gather(idx, epoch), epoch)

    def _step(self, state: TrainState, b: dict, epoch: int):
        """One step, as a ``step`` span that ends with the step's completion
        event (on CUDA, after the optimizer's kernels)."""
        self._epoch = epoch
        with self._span("step", epoch, len(b["target"])) as span:
            # per-epoch MultiStep lr (utils.py:81-86): lr * 0.1 per passed milestone
            lr = self.config.lr * 0.1 ** sum(epoch >= m for m in self.config.schedule)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.backbone.train()
            state.head.train()
            generator = self._draws(state.generator)
            x = b["input"]
            if self.train_augment is not None:
                x = self.train_augment(x, generator)
            encoding = state.backbone(x, generator=generator)
            if self.fds_config is not None:
                encoding = fds_smooth(self.fds_config, state.fds, encoding, b["target"], epoch,
                                      bucket_idx=b.get("bucket_idx"), mesh=self.mesh)
            pred = state.head(encoding, generator=generator)
            weights = self.weight_fn(b) if self.weight_fn is not None else b.get("weight")
            scale = self.config.target_scale
            target = b["target"] / scale if scale != 1.0 else b["target"]
            loss = self._loss_fn(pred, target, weights)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if self.mesh is not None:
                self._average_gradients(state)
            if self.config.clip_grad_norm is not None:
                clip_by_global_norm([p.grad for g in state.optimizer.param_groups
                                     for p in g["params"] if p.grad is not None],
                                    self.config.clip_grad_norm)
            state.optimizer.step()
            state.step += 1
            recorder.completed(span)
        return state, loss.detach(), pred.detach()

    @torch.no_grad()
    def _average_gradients(self, state: TrainState) -> None:
        """Average the gradients over the ranks: one all-reduce of one flat
        buffer. Parameters without a gradient (frozen: RRT's backbone, the
        STS-B word embeddings) are left out, on every rank alike."""
        grads = [p.grad for g in state.optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        if not grads:
            return
        flat = self.mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        flat.div_(self.mesh.world_size)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()

    def train_epoch(self, state: TrainState, batches: Iterable[dict], epoch: int, *,
                    start_step: int = 0, step_hook: Callable | None = None,
                    hook_every: int = 0):
        """One epoch over host batches, staged ahead of the step
        (:meth:`_device_batches`); returns (state, mean train loss).

        Losses stay on the device until the epoch ends; the loss-explosion
        guard (reference train.py:256) therefore fires at epoch granularity.

        ``start_step``: the epoch's step that ``batches`` starts at. A
        resumed epoch passes the (per-epoch-seeded) stream without its first
        ``start_step`` batches (``batch_iterator(skip=start_step)``), so they
        never reach the prefetcher and it goes on with the uninterrupted
        run's step sequence. ``step_hook(state, step_in_epoch)`` is called
        every ``hook_every`` completed steps with the post-step state, after
        a device sync. The call is a ``train_epoch`` span."""
        self._epoch = epoch
        with self._span("train_epoch", epoch):
            losses, counts = [], []
            with contextlib.closing(self._device_batches(batches)) as device_batches:
                for i, b in enumerate(device_batches, start=start_step):
                    counts.append(len(b["target"]))
                    state, loss, _ = self._step(state, b, epoch)
                    losses.append(loss)
                    if step_hook is not None and hook_every and (i + 1) % hook_every == 0:
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)
                        step_hook(state, i + 1)
            if not losses:
                return state, 0.0
            # single sync; under a mesh the global batches' losses (equal
            # shards: the mean of the ranks' means)
            with self._span("readback", epoch):
                losses = self.rank_mean(torch.stack(losses)).cpu().numpy()
        if np.any(~np.isfinite(losses)) or np.any(losses > 1e6):
            raise FloatingPointError(f"Loss explosion: max={losses.max()}")
        counts = np.asarray(counts)
        return state, float((losses * counts).sum() / counts.sum())

    def fds_epoch_pass(self, state: TrainState, batches: Iterable[dict], epoch: int) -> TrainState:
        """Epoch-end FDS stats pass (streaming moments), preserving the
        reference's snapshot-then-update ordering. Batches are staged as in
        :meth:`train_epoch`."""
        with contextlib.closing(self._device_batches(batches)) as device_batches:
            return self._fds_pass(state, device_batches, epoch)

    def fds_epoch_pass_indexed(self, state: TrainState, idx_batches: Iterable, epoch: int) -> TrainState:
        """:meth:`fds_epoch_pass` over index batches of the
        :meth:`bind_device_data` data."""
        return self._fds_pass(state, (self._gather(idx, epoch) for idx in idx_batches), epoch)

    @torch.no_grad()
    def _fds_pass(self, state: TrainState, device_batches: Iterable[dict], epoch: int) -> TrainState:
        cfg = self.fds_config
        if cfg is None or epoch < cfg.start_update:
            return state
        self._epoch = epoch
        with self._span("fds_pass", epoch):
            moments = fds_zero_moments(cfg, self.device)
            generator = self._draws(torch.Generator(device=self.device).manual_seed(epoch))
            # train-mode backbone (BN batch stats update and live dropout,
            # like the reference's model.train() + no_grad stats pass),
            # pre-smooth encodings, over the augmented train loader
            # (imdb-wiki-dir/train.py:273)
            state.backbone.train()
            for b in device_batches:
                x = b["input"]
                if self.train_augment is not None:
                    x = self.train_augment(x, generator)
                encoding = state.backbone(x, generator=generator)
                moments = moments + fds_bucket_moments(cfg, encoding, b["target"],
                                                       b.get("bucket_idx"))
            if self.mesh is not None:
                moments = all_reduce_moments(moments, self.mesh)  # once a pass
            fds = fds_update_last_epoch_stats(cfg, state.fds, epoch)
            state.fds = fds_apply_moments(cfg, fds, moments, epoch)
        return state

    @torch.no_grad()
    def predict_batch(self, state: TrainState, batch: dict, count: int | None = None) -> np.ndarray:
        """Predict one (possibly padded) eval batch; returns the first
        ``count`` rows on the host. Under a mesh each rank predicts its rows
        of the batch (its padded size must divide over the ranks) and every
        rank returns all of them, so all ranks decide alike on them."""
        n = count if count is not None else len(batch["target"])
        b = self._to_device(self._local(batch))
        state.backbone.eval()
        state.head.eval()
        x = b["input"]
        if self.eval_transform is not None:
            x = self.eval_transform(x)
        pred = self.all_rows(state.head(state.backbone(x)))
        with self._span("readback", rows=n):
            return pred.cpu().numpy()[:n]

    def predict(self, state: TrainState, batches: Iterable[dict]):
        """Gather predictions and targets on the host for metric computation
        (a ``predict`` span)."""
        preds, targets = [], []
        with self._span("predict"):
            for batch in batches:
                n = batch.pop("count", len(batch["target"]))
                preds.append(self.predict_batch(state, batch, n))
                targets.append(np.asarray(batch["target"])[:n])
        return np.concatenate(preds), np.concatenate(targets)


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """Clip ``grads`` in place by their global norm with optax's formula
    (``clip_by_global_norm``): ``g`` if ``norm < max_norm``, else ``g / norm
    * max_norm``. (``torch.nn.utils.clip_grad_norm_`` divides by ``norm +
    1e-6`` and would drift from the JAX package.) No host sync."""
    if not grads:
        return
    norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


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
