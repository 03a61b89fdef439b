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

- **Graphed step** (:class:`StepGraphs`): on CUDA without a mesh, a step
  replays one captured ``torch.cuda.CUDAGraph`` of the whole update (the
  augment, forward, K1, head, loss, backward with K2, clip and optimizer
  step) instead of dispatching it kernel by kernel. The graph key is the
  batch's shapes and dtypes, whether smoothing is on and the lr; a key's
  first step runs eagerly (it warms cuBLAS, autograd and the optimizer's
  state), its second captures, every later one replays. The CPU, a mesh
  and anomaly mode (``enable_nan_debug``) stay eager. Adam is built fused
  and ``capturable`` on CUDA, so eager and graphed steps run the same
  kernels and agree bit for bit.
- **Graphed stats pass**: where the step is graphed, each stats-pass batch
  replays one captured graph of its device work (the augment, the
  train-mode backbone, K3 and the addition into the pass's moments), keyed
  by ``("pass", ...)`` and the shapes and dtypes it reads, in the same pool
  and with the same eager first batch and capture on the second. The
  moments are static tensors of :class:`StepGraphs`, zeroed at each pass's
  start; the pass draws from one generator of the state's, seeded with the
  epoch at each pass's start, as the eager pass's fresh one is.

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

import collections
import contextlib
import dataclasses
import functools
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
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.ops.losses import LOSS_REGISTRY
from imbalanced_regression_tpu_torch.ops.moments import BucketMoments, all_reduce_moments
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


# the FDS tables a step's calibration (K1, K2) reads
_SMOOTH_TABLES = ("running_mean_last_epoch", "running_var_last_epoch",
                  "smoothed_mean_last_epoch", "smoothed_var_last_epoch")
# what a stats-pass batch's device work reads of the batch
_PASS_INPUTS = ("input", "target", "bucket_idx")


def _signature(tree: dict) -> tuple:
    """The keys, shapes and dtypes of a (nested) batch of tensors."""
    return tuple((k, _signature(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype))
                 for k, v in tree.items())


def _leaves(tree: dict) -> list[torch.Tensor]:
    return [leaf for v in tree.values() for leaf in (_leaves(v) if isinstance(v, dict) else [v])]


@dataclasses.dataclass
class _Graph:
    """One captured graph: the static inputs it reads, the kernel launches
    of each ``ck.KERNEL_WRAPPERS`` wrapper in it and of K3's kernels by
    name (``segment_moments.kernels``)."""

    graph: torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]
    launches: list[int]
    kernels: collections.Counter

    def run(self, batch: dict) -> None:
        """Replay on ``batch`` (copied into the static inputs), counting
        the graph's launches on the wrappers as eager calls count theirs."""
        for static, t in zip(self.inputs, _leaves(batch)):
            static.copy_(t)
        self.graph.replay()
        for fn, n in zip(ck.KERNEL_WRAPPERS, self.launches):
            fn.launches += n
        ck.segment_moments.kernels.update(self.kernels)


@dataclasses.dataclass
class _Captured(_Graph):
    """One captured step: the loss and predictions it writes, and each
    parameter's gradient tensor it writes."""

    loss: torch.Tensor
    pred: torch.Tensor
    grads: list[tuple[torch.Tensor, torch.Tensor]]
    smooth: bool


class StepGraphs:
    """A train state's captured steps and stats-pass batches, by graph key,
    in one memory pool.

    A captured step reads the addresses it was captured with, so what
    changes between steps is copied into them in place: the batch into the
    graph's static inputs, and after each stats pass the new FDS tables
    into the static tables that K1 and K2 read (the copy happens when the
    state's tables are other tensors than those last copied; an FDS
    transition never writes into the tensors of the old state). Each replay
    returns clones of the static loss and predictions, so a caller may keep
    them, and counts the graph's kernel launches on the wrappers, as the
    eager step's calls do. A captured stats-pass batch adds its moments
    into :attr:`moments` and draws from :attr:`pass_generator`, both made
    once and reset at each pass's start (:meth:`pass_start`). The graphs
    never replay at once, and each writes what it reads of the pool before
    reading it, so one's temporaries may lie where another's outputs do (a
    replay may overwrite the gradients that another step graph left in
    ``p.grad``, until that graph replays). :meth:`clear` drops every
    graph: whatever replaces tensors a graph holds (the optimizer's
    ``load_state_dict``, :func:`restore_state`, a new
    :meth:`Trainer.init_state`) calls it."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.entries: dict[tuple, _Graph] = {}
        self.warmed: set[tuple] = set()  # keys whose eager warm-up step or batch ran
        self.tables: tuple[torch.Tensor, ...] | None = None
        self.tables_of: tuple[torch.Tensor, ...] | None = None
        self.pool = None
        self.last: _Captured | None = None  # the graph whose gradients p.grad holds
        self.moments: BucketMoments | None = None  # the stats pass's, in place
        self.pass_generator: torch.Generator | None = None

    def pass_start(self, config: FDSConfig, device: torch.device,
                   epoch: int) -> tuple[BucketMoments, torch.Generator]:
        """The stats pass's moments, zeroed, and its generator, seeded with
        ``epoch`` (so it draws as a fresh generator so seeded would)."""
        if self.moments is None:
            self.moments = fds_zero_moments(config, device)
            self.pass_generator = torch.Generator(device=device)
        else:
            self.moments.zero_()
        return self.moments, self.pass_generator.manual_seed(epoch)

    def _capture(self, batch: dict, generator: torch.Generator, run: Callable):
        """Capture ``run(inputs)`` on ``inputs``, static copies of
        ``batch``, with ``generator``'s draws fresh on every replay.
        Returns the graph, what ``run`` returned (tensors the graph writes)
        and :class:`_Graph`'s fields: a capture launches nothing, so the
        launches the wrappers counted in it are taken back."""
        inputs = tree_map(torch.empty_like, batch)
        before = [fn.launches for fn in ck.KERNEL_WRAPPERS]
        kernels = ck.segment_moments.kernels.copy()
        graph, out = self._record(generator, lambda: run(inputs))
        launches = []
        for fn, n in zip(ck.KERNEL_WRAPPERS, before):
            launches.append(fn.launches - n)
            fn.launches = n
        added = ck.segment_moments.kernels - kernels
        ck.segment_moments.kernels.clear()
        ck.segment_moments.kernels.update(kernels)
        return out, _Graph(graph, _leaves(inputs), launches, added)

    def capture(self, key: tuple, batch: dict, fds: FDSState | None, generator: torch.Generator,
                params: list[torch.Tensor], update: Callable) -> _Captured:
        """Capture ``update(batch, fds)`` (returning the loss and the
        predictions) on static copies of ``batch`` and, where ``fds`` is
        given, of its calibration tables; ``generator`` draws fresh numbers
        on every replay."""
        if fds is not None:
            if self.tables is None:
                self.tables_of = tuple(getattr(fds, f) for f in _SMOOTH_TABLES)
                self.tables = tuple(t.clone() for t in self.tables_of)
            fds = fds.replace(**dict(zip(_SMOOTH_TABLES, self.tables)))
        (loss, pred), graph = self._capture(batch, generator, lambda inputs: update(inputs, fds))
        entry = _Captured(**vars(graph), loss=loss, pred=pred,
                          grads=[(p, p.grad) for p in params if p.grad is not None],
                          smooth=fds is not None)
        self.entries[key] = entry
        return entry

    def capture_pass(self, key: tuple, batch: dict, generator: torch.Generator,
                     run: Callable) -> _Graph:
        """Capture ``run(batch)``, one stats-pass batch's work, which adds
        into :attr:`moments` and returns nothing, on static copies of
        ``batch``."""

        def body(inputs):
            run(inputs)
            return ()

        _, entry = self._capture(batch, generator, body)
        self.entries[key] = entry
        return entry

    def _record(self, generator: torch.Generator, run: Callable):
        """Capture ``run()`` into a new graph of the pool, with
        ``generator``'s draws registered; returns the graph and what ``run``
        returned (tensors the graph writes)."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        # thread_local: the prefetch thread stages the next batches meanwhile
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            out = run()
        return graph, out

    def replay(self, entry: _Captured, batch: dict, fds: FDSState | None):
        """Run ``entry`` on ``batch`` and the state's tables; returns fresh
        (loss, predictions)."""
        if entry.smooth:
            tables = tuple(getattr(fds, f) for f in _SMOOTH_TABLES)
            if any(a is not b for a, b in zip(tables, self.tables_of)):
                for static, t in zip(self.tables, tables):
                    static.copy_(t)
                self.tables_of = tables
        entry.run(batch)
        if self.last is not entry:
            for p, g in entry.grads:
                p.grad = g
            self.last = entry
        return entry.loss.clone(), entry.pred.clone()


def graphable(device: torch.device, mesh: Mesh | None) -> bool:
    """Whether a step on ``device`` under ``mesh`` is graphed: on CUDA,
    without a mesh (its collectives stay eager) and outside anomaly mode
    (whose checks read values back in every op)."""
    return device.type == "cuda" and mesh is None and not torch.is_anomaly_enabled()


def _optimizer_loaded(graphs: StepGraphs, on_card: bool, optimizer) -> None:
    """After ``optimizer.load_state_dict``: the loaded moments are new
    tensors, so the graphs go; Adam keeps this trainer's form whatever form
    wrote the file (fused and capturable on CUDA, neither on the CPU), with
    its step counts on the parameters' device."""
    graphs.clear()
    for group in optimizer.param_groups:
        if "capturable" not in group:
            continue
        group["capturable"], group["fused"] = on_card, on_card or None
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(p.device, torch.float32)


@dataclasses.dataclass
class TrainState:
    step: int
    backbone: nn.Module
    head: nn.Module
    optimizer: torch.optim.Optimizer
    fds: FDSState | None
    generator: torch.Generator  # augmentation and dropout draws, on the device
    mesh: Mesh | None = None  # the data-parallel mesh the state is replicated on
    graphs: StepGraphs = dataclasses.field(default_factory=StepGraphs, repr=False, compare=False)


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
        # how often the graphed step engages (see StepGraphs)
        self.graph_stats = {"captures": 0, "replays": 0, "eager": 0}
        # how often the graphed stats-pass batch engages (Trainer._graphed_batch)
        self.pass_graph_stats = {"captures": 0, "replays": 0, "eager": 0}
        self._graphs: StepGraphs | None = None  # those of the newest state

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
        # On CUDA, Adam's fused capturable form: a few multi-tensor kernels a
        # step, its step counts on the device (the foreach capturable form
        # adds two power kernels a parameter); eager CUDA steps run it too,
        # so they agree bit for bit with graphed ones
        on_card = self.device.type == "cuda"
        if cfg.optimizer == "sgd":
            optimizer = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                                        weight_decay=cfg.weight_decay, dampening=0.0)
        else:
            optimizer = torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.adam_weight_decay,
                                         capturable=on_card, fused=on_card or None)
            optimizer._warned_capturable_if_run_uncaptured = True  # eager on purpose
        generator = torch.Generator(device=self.device).manual_seed(seed)
        fds = fds_init(self.fds_config, self.device) if self.fds_config else None
        if self._graphs is not None:
            self._graphs.clear()  # the modules' tensors may have moved
        graphs = self._graphs = StepGraphs()
        optimizer.register_load_state_dict_post_hook(
            functools.partial(_optimizer_loaded, graphs, on_card))
        state = TrainState(step=0, backbone=backbone, head=head, optimizer=optimizer, fds=fds,
                           generator=generator, mesh=self.mesh, graphs=graphs)
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
        event (on CUDA, after the optimizer's kernels). On CUDA without a
        mesh (and outside anomaly mode) the step is graphed
        (:meth:`_graphed_update`); elsewhere it runs eagerly."""
        self._epoch = epoch
        with self._span("step", epoch, len(b["target"])) as span:
            # per-epoch MultiStep lr (utils.py:81-86): lr * 0.1 per passed milestone
            lr = self.config.lr * 0.1 ** sum(epoch >= m for m in self.config.schedule)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.backbone.train()
            state.head.train()
            if graphable(self.device, self.mesh):
                loss, pred = self._graphed_update(state, b, epoch, lr)
            else:
                self.graph_stats["eager"] += 1
                loss, pred = self._update(state, b, state.fds, epoch)
            state.step += 1
            recorder.completed(span)
        return state, loss, pred

    def _graphed_update(self, state: TrainState, b: dict, epoch: int, lr: float):
        """The update as a replayed CUDA graph of ``state.graphs``, keyed by
        the batch's shapes and dtypes, whether smoothing is on and ``lr``
        (captured into the optimizer's kernels): a key's first step runs
        eagerly, its second captures (a ``capture`` span), and each step
        from the second on replays (a ``replay`` span)."""
        graphs = state.graphs
        smooth = self.fds_config is not None and epoch >= self.fds_config.start_smooth
        key = (_signature(b), smooth, lr)
        entry = graphs.entries.get(key)
        if entry is None:
            if key not in graphs.warmed:
                graphs.warmed.add(key)
                graphs.last = None  # p.grad now holds this step's gradients
                self.graph_stats["eager"] += 1
                return self._update(state, b, state.fds, epoch)
            params = [p for g in state.optimizer.param_groups for p in g["params"]]
            with self._span("capture", epoch):
                entry = graphs.capture(key, b, state.fds if smooth else None, state.generator,
                                       params, functools.partial(self._update, state, epoch=epoch))
            self.graph_stats["captures"] += 1
        with self._span("replay", epoch):
            out = graphs.replay(entry, b, state.fds)
        self.graph_stats["replays"] += 1
        return out

    def _update(self, state: TrainState, b: dict, fds: FDSState | None, epoch: int):
        """The step's device work: augment, forward, FDS calibration
        (against ``fds``), head, weighted loss, backward, gradient
        averaging under a mesh, clip and optimizer step. Returns the loss
        and the predictions, detached."""
        generator = self._draws(state.generator)
        x = b["input"]
        if self.train_augment is not None:
            x = self.train_augment(x, generator)
        encoding = state.backbone(x, generator=generator)
        if self.fds_config is not None:
            encoding = fds_smooth(self.fds_config, fds, encoding, b["target"], epoch,
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
        return loss.detach(), pred.detach()

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
        """The pass as an ``fds_pass`` span, each batch a ``pass_batch``
        span in it. On CUDA without a mesh (and outside anomaly mode) each
        batch's device work is a replayed graph (:meth:`_graphed_batch`);
        elsewhere it runs eagerly, and the pass draws from a fresh generator
        seeded with ``epoch``."""
        cfg = self.fds_config
        if cfg is None or epoch < cfg.start_update:
            return state
        self._epoch = epoch
        with self._span("fds_pass", epoch):
            graphed = graphable(self.device, self.mesh)
            if graphed:
                moments, generator = state.graphs.pass_start(cfg, self.device, epoch)
            else:
                moments = fds_zero_moments(cfg, self.device)
                generator = self._draws(torch.Generator(device=self.device).manual_seed(epoch))
            # train-mode backbone (BN batch stats update and live dropout,
            # like the reference's model.train() + no_grad stats pass),
            # pre-smooth encodings, over the augmented train loader
            # (imdb-wiki-dir/train.py:273)
            state.backbone.train()
            for b in device_batches:
                with self._span("pass_batch", epoch, len(b["target"])):
                    if graphed:
                        self._graphed_batch(state, b, moments, generator, epoch)
                    else:
                        self.pass_graph_stats["eager"] += 1
                        moments = moments + self._batch_moments(state, b, generator)
            if self.mesh is not None:
                moments = all_reduce_moments(moments, self.mesh)  # once a pass
            fds = fds_update_last_epoch_stats(cfg, state.fds, epoch)
            state.fds = fds_apply_moments(cfg, fds, moments, epoch)
        return state

    def _batch_moments(self, state: TrainState, b: dict, generator) -> BucketMoments:
        """One stats-pass batch's device work: augment, backbone, K3."""
        x = b["input"]
        if self.train_augment is not None:
            x = self.train_augment(x, generator)
        encoding = state.backbone(x, generator=generator)
        return fds_bucket_moments(self.fds_config, encoding, b["target"], b.get("bucket_idx"))

    def _graphed_batch(self, state: TrainState, b: dict, moments: BucketMoments,
                       generator: torch.Generator, epoch: int) -> None:
        """One stats-pass batch added into ``moments`` (the state's static
        moments) as a replayed CUDA graph of ``state.graphs``, keyed by
        ``("pass", ...)`` and the shapes and dtypes of what the batch's
        work reads: a key's first batch runs eagerly, its second captures
        (a ``pass_capture`` span), and each batch from the second on
        replays (a ``pass_replay`` span)."""
        graphs = state.graphs
        b = {k: b[k] for k in _PASS_INPUTS if k in b}
        key = ("pass", _signature(b))

        def run(batch):
            moments.add_(self._batch_moments(state, batch, generator))

        entry = graphs.entries.get(key)
        if entry is None:
            if key not in graphs.warmed:
                graphs.warmed.add(key)
                self.pass_graph_stats["eager"] += 1
                run(b)
                return
            with self._span("pass_capture", epoch):
                entry = graphs.capture_pass(key, b, generator, run)
            self.pass_graph_stats["captures"] += 1
        with self._span("pass_replay", epoch):
            entry.run(b)
        self.pass_graph_stats["replays"] += 1

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
    state.graphs.clear()
    state.backbone.load_state_dict(snapshot["backbone"])
    state.head.load_state_dict(snapshot["head"])
    state.fds = snapshot["fds"]
    return state
