"""Carry weights and FDS state from the JAX package into the port.

Inputs are nested dicts of numpy arrays (e.g. a Flax variables tree fetched
to the host with ``jax.device_get``); nothing here imports flax.

Layout transforms (``tools/convert_torch.py`` maps the same names the other
way):

- conv ``kernel`` HWIO → Conv2d ``weight`` OIHW (``transpose(3, 2, 0, 1)``);
- Dense ``kernel`` [in, out] → Linear ``weight`` [out, in];
- BatchNorm params ``scale``/``bias`` → ``weight``/``bias``, and
  ``batch_stats`` ``mean``/``var`` → ``running_mean``/``running_var``.

Flax names: the stem is ``Conv_0``/``BatchNorm_0``; the blocks are
``Bottleneck_{k}``, numbered globally across stages; inside a block
``Conv_0..2``/``BatchNorm_0..2``, with the downsample at
``Conv_3``/``BatchNorm_3``; the head is ``Dense_0``. A stage starts at every
block that has a downsample.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from imbalanced_regression_tpu_torch.fds import FDSState


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(tree: dict) -> torch.Tensor:
    return _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _bn(prefix: str, params: dict, stats: dict) -> dict:
    return {f"{prefix}.weight": _t(params["scale"]), f"{prefix}.bias": _t(params["bias"]),
            f"{prefix}.running_mean": _t(stats["mean"]), f"{prefix}.running_var": _t(stats["var"])}


def from_flax(variables_np: dict | None, head_params_np: dict | None = None) -> dict:
    """Convert a Flax ``ResNetBackbone`` variables tree (``{"params": ...,
    "batch_stats": ...}``) and the ``RegressionHead`` params (``{"Dense_0":
    ...}``) into ``{"backbone": state_dict, "head": state_dict}`` for
    :class:`models.resnet.ResNetBackbone` and
    :class:`models.resnet.RegressionHead`; either input may be None."""
    out = {}
    if variables_np is not None:
        out["backbone"] = _backbone_from_flax(variables_np["params"], variables_np["batch_stats"])
    if head_params_np is not None:
        dense = head_params_np["Dense_0"]
        out["head"] = {"linear.weight": _t(np.asarray(dense["kernel"]).T),
                       "linear.bias": _t(dense["bias"])}
    return out


def _backbone_from_flax(params: dict, stats: dict) -> dict:
    sd = {"conv1.weight": _conv(params["Conv_0"])}
    sd.update(_bn("bn1", params["BatchNorm_0"], stats["BatchNorm_0"]))
    num_blocks = sum(1 for k in params if k.startswith("Bottleneck_"))
    stage, index = 0, -1
    for k in range(num_blocks):
        bp, bs = params[f"Bottleneck_{k}"], stats[f"Bottleneck_{k}"]
        if "Conv_3" in bp and k > 0:  # first block of a new stage
            stage, index = stage + 1, 0
        else:
            index += 1
        t = f"layer{stage + 1}.{index}"
        for j in range(3):
            sd[f"{t}.conv{j + 1}.weight"] = _conv(bp[f"Conv_{j}"])
            sd.update(_bn(f"{t}.bn{j + 1}", bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"]))
        if "Conv_3" in bp:
            sd[f"{t}.downsample.0.weight"] = _conv(bp["Conv_3"])
            sd.update(_bn(f"{t}.downsample.1", bp["BatchNorm_3"], bs["BatchNorm_3"]))
    return sd


def fds_state_from_numpy(arrays: dict, device="cuda") -> FDSState:
    """Build an :class:`FDSState` from numpy arrays keyed by field name
    (e.g. the fields of a JAX ``FDSState`` fetched to the host)."""
    fields = [f.name for f in dataclasses.fields(FDSState)]
    missing = set(fields) - set(arrays)
    if missing:
        raise KeyError(f"missing FDS state fields: {sorted(missing)}")
    tensors = {k: _t(arrays[k]).to(device) for k in fields if k != "epoch"}
    return FDSState(epoch=int(np.asarray(arrays["epoch"])), **tensors)
