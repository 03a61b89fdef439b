"""Starting the ranks of a data-parallel run.

- :func:`run_ranks` runs a function on ``world_size`` local ranks, each a
  process of its own (``spawn``) with the default process group up over a
  ``file://`` store in a temporary directory, and returns the ranks'
  results in rank order. A rank that raises fails the call (the others are
  stopped), and so does a run that outlives its timeout.
- :func:`run_driver` is the drivers' ``main``: one device runs in this
  process as before; under ``torchrun`` (or inside a rank already in a
  process group) this process is one rank; otherwise it starts
  ``--num_devices`` local ranks with :func:`run_ranks` and returns rank 0's
  result, with every rank's :func:`rank_report` under ``"ranks"``.
  There is no fallback: ``--num_devices 2`` runs two ranks or raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    default_backend,
    initialize_multihost,
)
from imbalanced_regression_tpu_torch.train import resolve_device


def _rank_main(rank: int, fn: Callable, args: tuple, world_size: int, backend: str, tmp: str,
               timeout_s: float, cudnn_flags: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    # the ranks are on one host: gloo's transport stays on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # the caller's cuDNN choices hold in its ranks too
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    initialize_multihost(f"file://{os.path.join(tmp, 'store')}", world_size, rank,
                         backend=backend, timeout_s=timeout_s)
    result = fn(*args)
    dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(path + ".tmp", path)


def run_ranks(fn: Callable, world_size: int, *args, backend: str,
              timeout_s: float | None = None, collective_timeout_s: float = DEFAULT_TIMEOUT_S):
    """``fn(*args)`` on ``world_size`` local ranks (``fn`` and ``args`` are
    pickled: a module-level function); returns their results in rank order.
    Rank r has ``LOCAL_RANK=r``. ``timeout_s`` bounds the whole run (None:
    none; a hung collective still raises after ``collective_timeout_s``).
    The cuDNN ``deterministic`` and ``benchmark`` flags of this process
    hold in the ranks."""
    with tempfile.TemporaryDirectory(prefix="dp_ranks_") as tmp:
        cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, world_size, backend, tmp, collective_timeout_s, cudnn_flags),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=None if deadline is None
                               else max(deadline - time.monotonic(), 0.0)):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish within {timeout_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))  # written by our own ranks
    return results


def state_digest(state, *fds_states) -> str:
    """SHA-256 of a train state's weights and batch-norm buffers (both
    modules' ``state_dict``), its FDS state and any further FDS states, bit
    for bit: equal on every rank of a data-parallel run."""
    h = hashlib.sha256()

    def add(name, t):
        h.update(name.encode())
        h.update(t.detach().reshape(-1).cpu().contiguous().view(torch.uint8).numpy().tobytes())

    for part in ("backbone", "head"):
        for k, v in getattr(state, part).state_dict().items():
            add(f"{part}.{k}", v)
    for i, fds in enumerate((state.fds, *fds_states)):
        if fds is not None:
            for f in dataclasses.fields(fds):
                value = getattr(fds, f.name)
                if torch.is_tensor(value):
                    add(f"fds{i}.{f.name}", value)
    return h.hexdigest()


def rank_report(result: dict) -> dict:
    """What a driver's run did on this rank: its rank, this process's kernel
    launches (the counters are per process) and K3's by kernel, the digest
    of its final state (:func:`state_digest`, with the FDS state at the end
    of training), its step count and its mesh's collective statistics."""
    state, trainer = result.get("state"), result.get("trainer")
    mesh = trainer.mesh if trainer is not None else None
    return {
        "rank": dist.get_rank() if dist.is_initialized() else 0,
        "launches": {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS},
        "k3_kernels": dict(ck.segment_moments.kernels),
        "digest": None if state is None else state_digest(state, result.get("final_fds")),
        "steps": None if state is None else state.step,
        "collectives": None if mesh is None else dataclasses.asdict(mesh.stats),
    }


_LOCAL_ONLY = ("trainer", "state", "best_snapshot")  # modules and device state stay in the rank


def _to_host(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items() if k not in _LOCAL_ONLY}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to_host(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _driver_rank(run: Callable, config) -> dict:
    result = run(config)
    return {**_to_host(result), "rank": rank_report(result)}


def run_driver(run: Callable, config) -> dict:
    """Run a driver's ``run(config)`` on ``config.num_devices`` ranks (see
    the module docstring). The backend is ``config.dist_backend``, or NCCL
    on CUDA and gloo on the CPU."""
    world = config.num_devices or 1
    if world == 1:
        return run(config)
    device = resolve_device(config.device)
    backend = config.dist_backend or default_backend(device.type)
    if dist.is_initialized() or "RANK" in os.environ:
        if not dist.is_initialized():
            initialize_multihost(backend=backend)
        result = run(config)
        result["rank"] = rank_report(result)
        return result
    results = run_ranks(_driver_rank, world, run, config, backend=backend)
    return {**results[0], "ranks": [r["rank"] for r in results]}
