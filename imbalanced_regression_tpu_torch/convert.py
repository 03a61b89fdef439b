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
``Bottleneck_{k}`` (or ``BasicBlock_{k}`` for ResNet-18/34), numbered
globally across stages; inside a block ``Conv_0..2``/``BatchNorm_0..2``
(``Conv_0..1`` in a BasicBlock), with the downsample after them at
``Conv_3``/``BatchNorm_3`` (``Conv_2``/``BatchNorm_2``); the head is
``Dense_0``. A stage starts at every block after the first that has a
downsample (a BasicBlock stage 0 has none).

The depth encoder-decoder (:func:`depth_from_flax`) keeps the ResNet under
``encoder`` and names the rest in call order: ``Conv_0``/``BatchNorm_0``
(D's 1x1 conv), ``UpProjection_0..3`` (D), ``UpProjection_4..7`` (MFF, one
per encoder stage), ``Conv_1..3``/``BatchNorm_1..3`` (the MFF fuse and the
two R-trunk convs); inside an ``UpProjection``, ``Conv_0..2``/
``BatchNorm_0..2`` in the order conv1, conv1_2, conv2. Its head is
``Conv_0`` with a bias.

The STS-B pair encoder (:func:`stsb_from_flax`) maps ``embed.embedding``,
``highway/Dense_{i}``, ``bilstm/input_proj_{l}`` and
``bilstm/recurrent_kernel_{l}`` (the fused layout) onto the same names. The
per-direction layout's cells, ``bilstm/OptimizedLSTMCell_{k}`` (or
``bilstm/RNN_{k}/cell``, where a Flax version names the cell inside its
``nn.RNN``), are created forward then backward a layer, so cell ``k`` is
layer ``k // 2``, direction ``k % 2``; its gate kernels ``i{i,f,g,o}`` and
``h{i,f,g,o}`` (with the biases) are concatenated in gate order into
``bilstm.input_kernels_{l}``, ``recurrent_kernels_{l}`` and
``recurrent_biases_{l}`` [2, ...].

:func:`from_torchvision_resnet` takes a torchvision-format ResNet state dict
(the ImageNet weights the NYUD2 reference loads into its encoder); the
port's ResNets use torchvision's names, so it only filters and checks them.
"""

from __future__ import annotations

import dataclasses
import re

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
    block, n_convs = ("Bottleneck", 3) if "Bottleneck_0" in params else ("BasicBlock", 2)
    down = n_convs  # the downsample's Conv_/BatchNorm_ index
    num_blocks = sum(1 for k in params if k.startswith(f"{block}_"))
    stage, index = 0, -1
    for k in range(num_blocks):
        bp, bs = params[f"{block}_{k}"], stats[f"{block}_{k}"]
        if f"Conv_{down}" in bp and k > 0:  # first block of a new stage
            stage, index = stage + 1, 0
        else:
            index += 1
        t = f"layer{stage + 1}.{index}"
        for j in range(n_convs):
            sd[f"{t}.conv{j + 1}.weight"] = _conv(bp[f"Conv_{j}"])
            sd.update(_bn(f"{t}.bn{j + 1}", bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"]))
        if f"Conv_{down}" in bp:
            sd[f"{t}.downsample.0.weight"] = _conv(bp[f"Conv_{down}"])
            sd.update(_bn(f"{t}.downsample.1", bp[f"BatchNorm_{down}"], bs[f"BatchNorm_{down}"]))
    return sd


def depth_from_flax(variables_np: dict | None, head_params_np: dict | None = None) -> dict:
    """Convert a Flax ``DepthEncoderDecoder`` variables tree and the
    ``DepthHead`` params into ``{"backbone": state_dict, "head":
    state_dict}`` for :class:`models.depth_encdec.DepthEncoderDecoder` and
    :class:`models.depth_encdec.DepthHead`; either input may be None."""
    out = {}
    if variables_np is not None:
        params, stats = variables_np["params"], variables_np["batch_stats"]
        sd = {f"encoder.{k}": v
              for k, v in _backbone_from_flax(params["encoder"], stats["encoder"]).items()}
        convs = [("d_conv", "d_bn"), ("mff_conv", "mff_bn"), ("r_conv0", "r_bn0"),
                 ("r_conv1", "r_bn1")]
        for j, (conv, bn) in enumerate(convs):
            sd[f"{conv}.weight"] = _conv(params[f"Conv_{j}"])
            sd.update(_bn(bn, params[f"BatchNorm_{j}"], stats[f"BatchNorm_{j}"]))
        ups = [f"d_up.{k}" for k in range(4)] + [f"mff_up.{k}" for k in range(4)]
        for k, name in enumerate(ups):
            up_p, up_s = params[f"UpProjection_{k}"], stats[f"UpProjection_{k}"]
            for j, (conv, bn) in enumerate([("conv1", "bn1"), ("conv1_2", "bn1_2"),
                                            ("conv2", "bn2")]):
                sd[f"{name}.{conv}.weight"] = _conv(up_p[f"Conv_{j}"])
                sd.update(_bn(f"{name}.{bn}", up_p[f"BatchNorm_{j}"], up_s[f"BatchNorm_{j}"]))
        out["backbone"] = sd
    if head_params_np is not None:
        conv = head_params_np["Conv_0"]
        out["head"] = {"conv.weight": _conv(conv), "conv.bias": _t(conv["bias"])}
    return out


_CELL = re.compile(r"(OptimizedLSTMCell|RNN)_(\d+)")
_GATES = "ifgo"


def _per_direction_cells(cells: dict) -> dict:
    """Flax ``OptimizedLSTMCell`` params by creation index ``k`` (layer
    ``k // 2``, forward then backward) → the per-direction ``BiLSTM``
    state dict."""
    if sorted(cells) != list(range(len(cells))) or len(cells) % 2:
        raise KeyError(f"per-direction BiLSTM cells {sorted(cells)}: not two a layer")
    sd = {}
    for layer in range(len(cells) // 2):
        pair = [cells[2 * layer], cells[2 * layer + 1]]
        cat = lambda c, k: np.concatenate([np.asarray(c[f"{k}{g}"]["kernel"])  # noqa: E731
                                           for g in _GATES], axis=-1)
        sd[f"bilstm.input_kernels_{layer}"] = _t(np.stack([cat(c, "i") for c in pair]))
        sd[f"bilstm.recurrent_kernels_{layer}"] = _t(np.stack([cat(c, "h") for c in pair]))
        sd[f"bilstm.recurrent_biases_{layer}"] = _t(np.stack(
            [np.concatenate([np.asarray(c[f"h{g}"]["bias"]) for g in _GATES]) for c in pair]))
    return sd


def stsb_from_flax(variables_np: dict | None, head_params_np: dict | None = None) -> dict:
    """Convert a Flax ``PairBiLSTMEncoder`` variables tree (``{"params":
    {"embed", "highway", "bilstm"}}``, in either BiLSTM layout) and the
    ``RegressionHead`` params into ``{"backbone": state_dict, "head":
    state_dict}`` for :class:`models.bilstm_pair.PairBiLSTMEncoder` (with
    the matching ``lstm_impl``) and :class:`models.resnet.RegressionHead`;
    either input may be None. The recurrent kernels keep Flax's [H, 4H]
    layout (the port computes ``h @ W``). A ``bilstm`` key of neither layout
    raises ``KeyError``."""
    out = {}
    if variables_np is not None:
        params = variables_np["params"]
        sd = {"embed.weight": _t(params["embed"]["embedding"])}
        for name, dense in params.get("highway", {}).items():  # Dense_{i}
            i = int(name.removeprefix("Dense_"))
            sd[f"highway.layers.{i}.weight"] = _t(np.asarray(dense["kernel"]).T)
            sd[f"highway.layers.{i}.bias"] = _t(dense["bias"])
        cells = {}
        for name, p in params["bilstm"].items():
            cell = _CELL.fullmatch(name)
            if name.startswith("input_proj_"):
                sd[f"bilstm.{name}.weight"] = _t(np.asarray(p["kernel"]).T)
                sd[f"bilstm.{name}.bias"] = _t(p["bias"])
            elif name.startswith("recurrent_kernel_"):
                sd[f"bilstm.{name}"] = _t(p)
            elif cell:
                cells[int(cell.group(2))] = p["cell"] if cell.group(1) == "RNN" else p
            else:
                raise KeyError(f"not a BiLSTM parameter of either layout: {name!r}")
        sd.update(_per_direction_cells(cells))
        out["backbone"] = sd
    if head_params_np is not None:
        out["head"] = from_flax(None, head_params_np)["head"]
    return out


_BN_KEYS = r"(weight|bias|running_mean|running_var)"
# the keys of the port's ResNetBackbone / ResNetBasicBackbone, which are
# torchvision's minus ``fc.*`` and ``num_batches_tracked``
_RESNET_KEY = re.compile(
    rf"conv1\.weight|bn1\.{_BN_KEYS}"
    rf"|layer\d+\.\d+\.(conv\d\.weight|bn\d\.{_BN_KEYS}|downsample\.0\.weight"
    rf"|downsample\.1\.{_BN_KEYS})")


def normalize_state_dict(sd: dict) -> dict:
    """Unwrap ``{'state_dict': ...}`` / ``{'model': ...}`` containers and strip
    the ``module.`` prefix of a ``DataParallel`` save (as
    ``tools/convert_torch.normalize_state_dict`` does)."""
    for wrapper in ("state_dict", "model"):
        if wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
    return {k.removeprefix("module."): v for k, v in sd.items()}


def from_torchvision_resnet(state_dict: dict) -> dict:
    """A torchvision ResNet state dict as a float32 state dict for the port's
    ResNet backbones (e.g. ``DepthEncoderDecoder.encoder``): ``fc.*`` and
    ``num_batches_tracked`` are dropped, any other key that is not a
    backbone key raises ``KeyError``. Shapes are checked by the strict
    ``load_state_dict`` that takes the result."""
    out = {}
    for k, v in normalize_state_dict(state_dict).items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        if not _RESNET_KEY.fullmatch(k):
            raise KeyError(f"not a ResNet backbone key: {k!r}")
        out[k] = torch.as_tensor(v).detach().to(torch.float32).clone()
    return out


def fds_state_from_numpy(arrays: dict, device="cuda") -> FDSState:
    """Build an :class:`FDSState` from numpy arrays keyed by field name
    (e.g. the fields of a JAX ``FDSState`` fetched to the host)."""
    fields = [f.name for f in dataclasses.fields(FDSState)]
    missing = set(fields) - set(arrays)
    if missing:
        raise KeyError(f"missing FDS state fields: {sorted(missing)}")
    tensors = {k: _t(arrays[k]).to(device) for k in fields if k != "epoch"}
    return FDSState(epoch=int(np.asarray(arrays["epoch"])), **tensors)
