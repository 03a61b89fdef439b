"""Checkpoints of the full train state, with a separate "best" copy.

The PyTorch counterpart of the JAX package's Orbax checkpoints
(``utils/checkpoint.py``), written with ``torch.save``. A checkpoint is one
file, ``<ckpt_dir>/latest.pt`` or ``<ckpt_dir>/best.pt``, holding:

- ``backbone``, ``head``: the modules' ``state_dict`` (weights and BN
  running buffers);
- ``optimizer``: the optimizer's ``state_dict`` (Adam's moments and step,
  SGD's momentum buffers);
- ``fds``: the FDS state as a dict of tensors plus its host ``epoch``, or
  None;
- ``step`` and ``generator`` (the device generator's ``get_state()``), so a
  resumed run draws the augmentation and dropout of the uninterrupted one;
- ``meta``: ``{"epoch", "best_loss"}``, and ``"metric_state"`` (the STS
  driver's validation history) when the caller gives one: written in the
  same file as the state it belongs to, so no crash can leave the two out
  of step (the JAX package writes its ``metric_state`` file after the
  checkpoint, and a crash between the two writes resumes with the history
  one check short).

Each write goes to a temporary file first and is moved into place with
``os.replace``, so a run killed during a save keeps the previous file whole.
Replaces the reference's ``torch.save({'epoch', 'model', 'best_loss',
'state_dict', 'optimizer'})`` + best-copy flow (``imdb-wiki-dir/utils.py:89-94``,
``train.py:185-196,209-215``). Also provides the RRT backbone-only load
(``train.py:174-183``).

Under a data-parallel mesh the state is replicated, so rank 0 alone writes
it (the file is the one-process run's, and loads into one) while the other
ranks wait at a barrier; every rank reads a checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import torch

from imbalanced_regression_tpu_torch.fds import FDSState


def checkpoint_path(ckpt_dir: str, which: str = "latest") -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"{which}.pt")


def has_checkpoint(ckpt_dir: str, which: str = "latest") -> bool:
    return os.path.isfile(checkpoint_path(ckpt_dir, which))


def _fds_to_dict(fds: FDSState | None) -> dict | None:
    # not dataclasses.asdict: it deep-copies every tensor
    return None if fds is None else {f.name: getattr(fds, f.name) for f in dataclasses.fields(fds)}


def _fds_from_dict(d: dict, device: torch.device) -> FDSState:
    return FDSState(**{k: v if k == "epoch" else v.to(device) for k, v in d.items()})


def _device(state) -> torch.device:
    return next(state.head.parameters()).device


def save_checkpoint(ckpt_dir: str, state, epoch: int, best_loss: float, is_best: bool,
                    metric_state: dict | None = None) -> None:
    """Save the ``latest`` (and, if ``is_best``, the ``best``) checkpoint,
    with ``metric_state`` in its ``meta`` when given. For a state on a
    data-parallel mesh (``state.mesh``) rank 0 writes and every rank
    returns once it has."""
    mesh = state.mesh
    if mesh is None or mesh.rank == 0:
        _write_checkpoint(ckpt_dir, state, epoch, best_loss, is_best, metric_state)
    if mesh is not None:
        mesh.barrier()


def _write_checkpoint(ckpt_dir: str, state, epoch: int, best_loss: float, is_best: bool,
                      metric_state: dict | None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "backbone": state.backbone.state_dict(),
        "head": state.head.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "fds": _fds_to_dict(state.fds),
        "step": int(state.step),
        "generator": state.generator.get_state(),
        "meta": {"epoch": int(epoch), "best_loss": float(best_loss)},
    }
    if metric_state is not None:
        payload["meta"]["metric_state"] = metric_state
    latest = checkpoint_path(ckpt_dir, "latest")
    torch.save(payload, latest + ".tmp")
    if is_best:
        best = checkpoint_path(ckpt_dir, "best")
        shutil.copyfile(latest + ".tmp", best + ".tmp")
        os.replace(best + ".tmp", best)
    os.replace(latest + ".tmp", latest)


def read_checkpoint(ckpt_dir: str, which: str = "latest") -> dict:
    """The raw payload of a checkpoint, on the CPU."""
    return torch.load(checkpoint_path(ckpt_dir, which), map_location="cpu", weights_only=True)


def checkpoint_meta(ckpt_dir: str, which: str = "latest") -> dict:
    """The ``meta`` entry of a checkpoint; the file is memory-mapped, so its
    tensors are not read."""
    return torch.load(checkpoint_path(ckpt_dir, which), map_location="cpu", weights_only=True,
                      mmap=True)["meta"]


def checkpoint_lstm_impl(ckpt_dir: str, which: str = "latest") -> str | None:
    """The BiLSTM layout an STS-B checkpoint was written with, from its
    backbone's keys: ``"fused"`` (``bilstm.input_proj_0.weight``),
    ``"flax"`` (``bilstm.input_kernels_0``, the per-direction layout), or
    None where there is no such checkpoint or it holds neither (the file is
    memory-mapped, so its tensors are not read)."""
    if not has_checkpoint(ckpt_dir, which):
        return None
    keys = torch.load(checkpoint_path(ckpt_dir, which), map_location="cpu", weights_only=True,
                      mmap=True)["backbone"].keys()
    if "bilstm.input_proj_0.weight" in keys:
        return "fused"
    if "bilstm.input_kernels_0" in keys:
        return "flax"
    return None


def restore_checkpoint(ckpt_dir: str, state, which: str = "latest"):
    """Load a checkpoint into ``state`` (modules, optimizer, FDS state, step,
    generator) in place; returns ``(state, epoch, best_loss)``. The state
    must have the checkpoint's structure (same model, optimizer and FDS
    config)."""
    payload = read_checkpoint(ckpt_dir, which)
    state.backbone.load_state_dict(payload["backbone"])
    state.head.load_state_dict(payload["head"])
    state.optimizer.load_state_dict(payload["optimizer"])
    fds = payload["fds"]
    state.fds = None if fds is None else _fds_from_dict(fds, _device(state))
    state.step = payload["step"]
    state.generator.set_state(payload["generator"])
    meta = payload["meta"]
    return state, int(meta["epoch"]), float(meta["best_loss"])


def load_backbone_params(ckpt_dir: str, state, which: str = "best", restore_fds: bool = True):
    """RRT stage 2: load the backbone's weights and BN buffers only, keeping
    the fresh head and optimizer (the reference drops the 'linear'/'fc'
    keys, ``imdb-wiki-dir/train.py:174-183``, and never reads the optimizer).

    ``restore_fds``: the age suites' key filter keeps ``module.FDS.*``, so the
    FDS running statistics load too when both the checkpoint and ``state``
    have them; a checkpoint without them (a run without FDS) leaves the fresh
    ones. STS's backbone-only resume loads none (``sts-b-dir/util.py:75-84``):
    pass False."""
    payload = read_checkpoint(ckpt_dir, which)
    state.backbone.load_state_dict(payload["backbone"])
    if restore_fds and state.fds is not None and payload["fds"] is not None:
        state.fds = _fds_from_dict(payload["fds"], _device(state))
    return state


def state_byte_size(state) -> int:
    """Bytes of the tensors a checkpoint of ``state`` holds."""
    tensors = [*state.backbone.state_dict().values(), *state.head.state_dict().values()]
    for per_param in state.optimizer.state.values():
        tensors += [v for v in per_param.values() if torch.is_tensor(v)]
    if state.fds is not None:
        tensors += [v for v in _fds_to_dict(state.fds).values() if torch.is_tensor(v)]
    return sum(t.numel() * t.element_size() for t in tensors)
