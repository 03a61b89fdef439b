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
- ``meta``: ``{"epoch", "best_loss"}``.

Each write goes to a temporary file first and is moved into place with
``os.replace``, so a run killed during a save keeps the previous file whole.
Replaces the reference's ``torch.save({'epoch', 'model', 'best_loss',
'state_dict', 'optimizer'})`` + best-copy flow (``imdb-wiki-dir/utils.py:89-94``,
``train.py:185-196,209-215``). Also provides the RRT backbone-only load
(``train.py:174-183``) and the STS metric-history files.
"""

from __future__ import annotations

import dataclasses
import json
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


def save_checkpoint(ckpt_dir: str, state, epoch: int, best_loss: float, is_best: bool) -> None:
    """Save the ``latest`` (and, if ``is_best``, the ``best``) checkpoint."""
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


def save_metric_state(ckpt_dir: str, history, best: float, is_best: bool) -> None:
    """Persist the validation-metric history beside the state checkpoint.

    The reference stores the per-metric history in ``metric_state.th``
    (``sts-b-dir/trainer.py:357-363``) and restores it on resume
    (``trainer.py:398-402``), so patience decisions after a resume are those
    of an uninterrupted run. Writes are tmp + rename."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"hist": [float(h) for h in history], "best": float(best)}
    names = ["metric_state.json"] + (["metric_state_best.json"] if is_best else [])
    for name in names:
        tmp = os.path.join(ckpt_dir, name + ".tmp")
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, os.path.join(ckpt_dir, name))


def load_metric_state(ckpt_dir: str, which: str = "latest") -> dict | None:
    """``{'hist': [...], 'best': float}``, or None if never saved."""
    name = "metric_state.json" if which == "latest" else "metric_state_best.json"
    path = os.path.join(os.path.abspath(ckpt_dir), name)
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def state_byte_size(state) -> int:
    """Bytes of the tensors a checkpoint of ``state`` holds."""
    tensors = [*state.backbone.state_dict().values(), *state.head.state_dict().values()]
    for per_param in state.optimizer.state.values():
        tensors += [v for v in per_param.values() if torch.is_tensor(v)]
    if state.fds is not None:
        tensors += [v for v in _fds_to_dict(state.fds).values() if torch.is_tensor(v)]
    return sum(t.numel() * t.element_size() for t in tensors)
