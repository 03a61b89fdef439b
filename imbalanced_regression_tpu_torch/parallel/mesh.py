"""Data-parallel mesh over ``torch.distributed`` process groups.

The counterpart of the JAX package's ``parallel/mesh.py``. There, one jitted
step runs over a 1-D ``data`` mesh with the batch sharded and the state
replicated, and GSPMD makes every reduction over the batch global. Here each
device is one process (a rank) running the same eager program, and the
reductions are made global by hand, with ``all_reduce`` only (gloo has no
all-gather for CUDA tensors):

- ``--batch_size`` is the global batch; rank r takes rows ``[r*n/W,
  (r+1)*n/W)`` of it (:func:`shard_batch`, JAX's multi-process ``_put``:
  every process passes the same global batch);
- the state is replicated: every rank seeds identically and
  :func:`replicate` broadcasts rank 0's parameters, buffers and FDS state;
- the reductions GSPMD makes global: batch-norm statistics
  (``models/resnet.py``), the mean loss's gradient (``train.py``), the FDS
  stats pass's moments (``ops/moments.py``) and the age grouping's
  edge-label gate (``fds.py``);
- random draws (augmentation, dropout) are made at the global batch's shape
  from a generator every rank holds in the same state, and each rank keeps
  its rows (:class:`ShardedGenerator`), so row i gets the draws row i gets
  in the one-process run.

:func:`initialize_multihost` brings up the process group (under
``torchrun`` from its environment); ``parallel/launch.py`` starts local
ranks itself.
"""

from __future__ import annotations

import dataclasses
import os
import time
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn as nn

from imbalanced_regression_tpu_torch.data.batching import tree_map

# a hung collective raises after this long instead of running into a caller's limit
DEFAULT_TIMEOUT_S = 600.0
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def default_backend(device_type: str) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *, backend: str | None = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Bring up the default process group of a multi-process run.

    With no address, the usual ``torchrun`` environment gives it (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks
    the card in :func:`create_mesh`). ``coordinator_address`` is
    ``host:port`` (a TCP store on rank 0) or a store URL (``tcp://...``,
    ``file://...``). The backend defaults to NCCL where CUDA is available,
    else gloo."""
    if backend is None:
        backend = default_backend("cuda" if torch.cuda.is_available() else "cpu")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, timeout=timedelta(seconds=timeout_s))


@dataclasses.dataclass
class CollectiveStats:
    """Collective calls made through a :class:`Mesh`, the bytes they reduced
    and the host seconds spent in them. Gloo blocks until the reduction is
    done, so there the seconds include waiting for the device to reach the
    collective; NCCL only enqueues it, so there they are the enqueue."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0


@dataclasses.dataclass
class Mesh:
    """A 1-D data-parallel mesh: the process group, this process's rank in
    it, the number of ranks, this rank's device and the group's backend.
    Its collectives count themselves in ``stats``."""

    group: dist.ProcessGroup
    rank: int
    world_size: int
    device: torch.device
    backend: str
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over the ranks (``op`` "sum" or "max");
        returns it."""
        t0 = time.perf_counter()
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        self.stats.seconds += time.perf_counter() - t0
        self.stats.calls += 1
        self.stats.bytes += t.numel() * t.element_size()
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks, in a new tensor."""
        return self.all_reduce(t.clone()).div_(self.world_size)

    def gather_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` stacked along ``dim`` in rank order: the
        global batch's rows from each rank's. An all-reduce into a zeroed
        global buffer (adding zeros leaves every value as it was)."""
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * self.world_size
        out = t.new_zeros(shape)
        out.narrow(dim, self.rank * n, n).copy_(t)
        return self.all_reduce(out)

    def barrier(self) -> None:
        """Return once every rank has reached this point (an all-reduce the
        host waits for, on either backend)."""
        self.all_reduce(torch.zeros(1, device=self.device)).item()

    def sharded(self, generator: torch.Generator) -> "ShardedGenerator":
        return ShardedGenerator(generator, self.rank, self.world_size)

    def __deepcopy__(self, memo) -> "Mesh":
        # a handle on the process's group: a copied module shares it
        return self


def create_mesh(num_devices: int | None = None, backend: str | None = None,
                device: str | torch.device | None = None) -> Mesh:
    """The mesh of the current process group, one device a rank.

    With no process group and at most one device asked for, a one-rank
    group is made in this process (an in-memory store). More devices than
    ranks raise, as the JAX ``create_mesh`` raises for more devices than
    exist. ``device`` ("cuda", the default, or "cpu") says where the ranks
    run; on CUDA, rank ``LOCAL_RANK`` takes card ``LOCAL_RANK``, and more
    ranks on a host than it has cards raise, unless the caller asks for
    ``backend="gloo"``: then ranks share the cards round-robin (NCCL
    refuses two ranks on one card). ``torch.cuda.set_device`` is called for
    the rank's card, so the kernels' current stream is that card's. The
    backend defaults to NCCL on CUDA and gloo on the CPU."""
    device_type = torch.device("cuda" if device is None else device).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' (or --device cpu) "
                           "to run on the CPU")
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise RuntimeError(f"{num_devices} devices need {num_devices} processes: start them "
                               "with torchrun or parallel.launch.run_ranks")
        dist.init_process_group(backend or default_backend(device_type), store=dist.HashStore(),
                                rank=0, world_size=1,
                                timeout=timedelta(seconds=DEFAULT_TIMEOUT_S))
    world, rank, in_use = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    if backend is not None and backend != in_use:
        raise ValueError(f"asked for backend {backend!r}, the process group runs {in_use!r}")
    if num_devices is not None and num_devices != world:
        raise ValueError(f"requested {num_devices} devices, the process group has {world} ranks")
    if device_type == "cpu":
        if in_use == "nccl":
            raise ValueError("NCCL runs on CUDA devices only; use backend='gloo' on the CPU")
        dev = torch.device("cpu")
    else:
        cards = torch.cuda.device_count()
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local_world > cards and backend != "gloo":
            raise ValueError(f"requested {local_world} devices, have {cards}; pass "
                             "backend='gloo' (--dist_backend gloo) to share cards")
        torch.cuda.set_device(local_rank % cards)
        dev = torch.device("cuda", local_rank % cards)
    return Mesh(dist.group.WORLD, rank, world, dev, in_use)


def rank0_first(mesh: Mesh | None, fn: Callable):
    """``fn()`` on rank 0, then on the other ranks once rank 0 is done (so
    they find the on-disk caches that rank 0 wrote); ``fn()`` alone without
    a mesh."""
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()
    out = fn()
    if mesh is not None and mesh.rank == 0:
        mesh.barrier()
    return out


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global host batch (a nested dict of arrays, or
    one array): the leading axis split into ``world_size`` contiguous
    blocks, in rank order; raises when the ranks cannot split it evenly.
    Every rank must pass the same global batch."""

    def rows(v):
        n = len(v)
        if n % mesh.world_size:
            raise ValueError(f"a batch of {n} rows does not divide over {mesh.world_size} ranks")
        k = n // mesh.world_size
        return v[mesh.rank * k:(mesh.rank + 1) * k]

    return tree_map(rows, batch)


def _tensors(obj):
    """The tensors of a module (its ``state_dict``: parameters and
    buffers), a dataclass, dict, list or tuple of them, or a tensor."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, nn.Module):
        yield from obj.state_dict().values()
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


@torch.no_grad()
def replicate(mesh: Mesh, state) -> None:
    """Overwrite, in place, every tensor of ``state`` (a train state: its
    modules' parameters and buffers and its FDS state) with rank 0's: one
    broadcast a device and dtype."""
    groups: dict = {}
    for t in _tensors(state):
        groups.setdefault((t.device, t.dtype), []).append(t)
    for tensors in groups.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        t0 = time.perf_counter()
        dist.broadcast(flat, src=0, group=mesh.group)
        mesh.stats.seconds += time.perf_counter() - t0
        mesh.stats.calls += 1
        mesh.stats.bytes += flat.numel() * flat.element_size()
        if mesh.rank != 0:
            offset = 0
            for t in tensors:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()


# ---------------------------------------------------------------------------
# random draws at the global batch's shape
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedGenerator:
    """A generator that every rank holds in the same state, with this
    rank's place in the global batch. The draw functions below make a
    batch's draws at the global batch's shape and keep this rank's rows, so
    the generator moves on as in the one-process run, on every rank."""

    generator: torch.Generator
    rank: int
    world_size: int


def _draw(fn: Callable, shape, generator, groups: int) -> torch.Tensor:
    """``fn(shape, generator)`` for a plain generator (or None); for a
    :class:`ShardedGenerator`, ``fn`` at the global shape and this rank's
    rows of it. The leading axis holds ``groups`` blocks of this rank's
    rows (a sentence pair's two columns stacked: ``groups=2``); the global
    draw holds the same blocks of the global batch."""
    shape = tuple(shape)
    if not isinstance(generator, ShardedGenerator):
        return fn(shape, generator)
    n, rest = shape[0] // groups, shape[1:]
    full = fn((groups * generator.world_size * n, *rest), generator.generator)
    return full.reshape(groups, generator.world_size, n, *rest)[:, generator.rank].reshape(shape)


def rand(shape, generator, device, groups: int = 1) -> torch.Tensor:
    """``torch.rand`` of this rank's rows (see :func:`_draw`)."""
    return _draw(lambda s, g: torch.rand(s, generator=g, device=device), shape, generator, groups)


def randn(shape, generator, device, groups: int = 1) -> torch.Tensor:
    """``torch.randn`` of this rank's rows (see :func:`_draw`)."""
    return _draw(lambda s, g: torch.randn(s, generator=g, device=device), shape, generator, groups)


def randint(high: int, shape, generator, device, groups: int = 1) -> torch.Tensor:
    """``torch.randint(0, high)`` of this rank's rows (see :func:`_draw`)."""
    return _draw(lambda s, g: torch.randint(0, high, s, generator=g, device=device), shape,
                 generator, groups)
