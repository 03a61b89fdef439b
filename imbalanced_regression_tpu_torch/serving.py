"""Serving export: freeze a trained model into a self-contained predictor.

The PyTorch counterpart of the JAX package's ``serving.py``. The reference
has no serving story (inference happens inside the training scripts via
``--evaluate``, e.g. ``imdb-wiki-dir/train.py:103-110``); this module bakes a
trained :class:`train.TrainState` into a frozen program:

- :func:`export_predictor`: close the eval path over the trained weights
  (backbone and head in eval mode, batch norm on its running statistics;
  FDS never runs at inference, as in the reference's eval path), trace it
  with ``torch.export`` for one input shape and dtype, and pack the
  ``.pt2`` archive (graph, weights and constants) into one artifact.
- :func:`load_predictor`: rebuild a callable ``numpy input -> numpy
  predictions`` from the artifact; no model code, no trainer and no
  checkpoint directory are needed (this module imports none of them).

One program per device. ``torch.export`` fixes the device a trace ran on in
the graph: the backbones' ``torch.autocast(device_type=...)`` becomes a node
bound to it, and constants made at trace time (the depth decoder's resize
weights, ``models/depth_encdec.py``; the STS-B recurrence's zero states)
live on it. So each entry of ``platforms`` is traced on its own device, and
the artifact holds one program per device, as the JAX package's
multi-platform lowering holds one module for several platforms.

Artifact layout: ``_MAGIC``, a little-endian u64 header length, a JSON
header (``platforms``, each program's byte size, the input signature), then
the programs' ``.pt2`` archives in the order of ``platforms``.

CLIs: ``python -m imbalanced_regression_tpu_torch.tools.export_model`` and
``python -m imbalanced_regression_tpu_torch.tools.serve_bench``.
"""

from __future__ import annotations

import copy
import io
import json
import struct
import warnings
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn as nn

# this port's container magic; the JAX package's packages start with b"IRTSRV1\n"
_MAGIC = b"IRTSRV-TORCH1\n"
_JAX_MAGIC = b"IRTSRV1\n"
PLATFORMS = ("cuda", "cpu")


class Aval(NamedTuple):
    """Shape and dtype of one input leaf of the serving signature."""

    shape: tuple[int, ...]
    dtype: np.dtype


class InferModule(nn.Module):
    """``input -> predictions``: the eval transform, then the backbone and
    the head (both in eval mode)."""

    def __init__(self, backbone: nn.Module, head: nn.Module, transform: Callable | None):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.transform = transform

    def forward(self, x):
        if self.transform is not None:
            x = self.transform(x)
        return self.head(self.backbone(x))


def make_infer_fn(trainer, state) -> InferModule:
    """The eval path of ``trainer`` over ``state``'s modules, in eval mode:
    the same math as ``Trainer.predict_batch`` without the host padding
    bookkeeping. The module shares the state's weights (and puts its
    modules in eval mode, as ``predict_batch`` does)."""
    return InferModule(state.backbone, state.head, trainer.eval_transform).eval()


def _leaves(sample) -> list[tuple[str | None, np.ndarray]]:
    """(key, array) per input leaf: one unnamed array, or a dict's entries
    in sorted key order (the order of a JAX pytree's leaves)."""
    if isinstance(sample, dict):
        return [(k, np.asarray(sample[k])) for k in sorted(sample)]
    return [(None, np.asarray(sample))]


def _on_device(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` if every parameter and buffer is on ``device``, else a copy
    moved there."""
    tensors = [*module.parameters(), *module.buffers()]
    if all(t.device == device for t in tensors):
        return module
    return copy.deepcopy(module).to(device)


def _device_of(platform: str) -> torch.device:
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; choices: {PLATFORMS}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available to export the 'cuda' program on; "
                           "pass platforms=('cpu',) (or --platforms cpu) for a CPU artifact")
    return torch.device("cuda", torch.cuda.current_device()) if platform == "cuda" \
        else torch.device("cpu")


def export_predictor(
    trainer,
    state,
    sample_input,
    platforms: Sequence[str] = ("cuda",),
    embed_weights: bool = True,
) -> bytes:
    """Serialize the frozen predictor for ``sample_input``'s shapes and
    dtypes on each of ``platforms`` (``"cuda"``, ``"cpu"``).

    ``sample_input`` fixes the serving signature: a uint8 or float32 NHWC
    array for the image tasks, or STS-B's dict of four arrays
    (``tokens1``/``mask1``/``tokens2``/``mask2``). Shapes are static: one
    program per input shape, the rule of the JAX package and of the
    training stack. The trace runs under ``torch.no_grad``.

    ``embed_weights`` is kept for the JAX API's sake and changes nothing
    here. In JAX, ``True`` bakes the weights into the StableHLO module as
    constants, and ``False`` exports a function of ``(weights, x)`` packed
    with a weight pack, because an embedded module can exceed a remote
    compile service's request limit. A ``.pt2`` archive always stores the
    weights beside the graph in the one file, and nothing compiles it on
    load, so both values give the same self-contained artifact."""
    del embed_weights  # both layouts are the one .pt2 archive (docstring)
    platforms = tuple(platforms)
    if not platforms or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms must be distinct and non-empty, got {platforms}")
    leaves = _leaves(sample_input)
    infer = make_infer_fn(trainer, state)
    programs = []
    for platform in platforms:
        device = _device_of(platform)
        module = _on_device(infer, device)
        tensors = {k: torch.as_tensor(a).to(device) for k, a in leaves}
        args = (tensors if isinstance(sample_input, dict) else tensors[None],)
        with torch.no_grad():
            program = torch.export.export(module, args)
        # the archive would keep the sample itself (19.3 MB for a uint8
        # batch of 128 at 224x224, and a caller's data, which the JAX
        # artifact never holds); the signature lives in the header
        program.example_inputs = None
        buf = io.BytesIO()
        with warnings.catch_warnings():
            # channels_last convolution weights are not contiguous, so the
            # archive writer stores each one's whole storage and warns that
            # it found no contiguous tensor covering it: the bytes are whole
            warnings.filterwarnings("ignore", message="No complete tensor found")
            torch.export.save(program, buf)
        programs.append(buf.getvalue())
    header = json.dumps({
        "platforms": list(platforms),
        "sizes": [len(p) for p in programs],
        "inputs": [[k, list(a.shape), a.dtype.str] for k, a in leaves],
    }).encode()
    return b"".join([_MAGIC, struct.pack("<Q", len(header)), header, *programs])


class Predictor:
    """A loaded program: ``predictor(x)`` takes a numpy array (or STS-B's
    dict of arrays) of the exported shape and dtype, runs on ``device``
    under ``torch.inference_mode`` and returns the predictions on the host.

    ``in_shape``: the input's shape, None for a dict input; ``data_avals``:
    an :class:`Aval` per input leaf (a dict's in sorted key order);
    ``platforms``: the devices the artifact holds programs for; ``device``:
    the device this one runs on; ``module``: the loaded graph module."""

    def __init__(self, module: nn.Module, device: torch.device, platforms: tuple[str, ...],
                 inputs: list):
        self.module = module
        self.device = device
        self.platforms = platforms
        self._keys = [k for k, _, _ in inputs]  # [None] for one array
        self.data_avals = tuple(Aval(tuple(s), np.dtype(d)) for _, s, d in inputs)
        self.in_shape = self.data_avals[0].shape if self._keys == [None] else None

    def to_device(self, x):
        """``x`` checked against the signature and copied to the device."""
        keys = sorted(x) if isinstance(x, dict) else [None]
        if keys != self._keys:
            want = "one array" if self._keys == [None] else f"a dict of {self._keys}"
            raise ValueError(f"the predictor takes {want}")
        leaves = _leaves(x)
        for (key, a), want in zip(leaves, self.data_avals):
            if a.shape != want.shape or a.dtype != want.dtype:
                name = f"input {key!r}" if key else "input"
                raise ValueError(f"{name} is {a.dtype}{list(a.shape)}; the predictor was exported "
                                 f"for {want.dtype}{list(want.shape)} (one program per shape)")
        tensors = {k: torch.as_tensor(a).to(self.device) for k, a in leaves}
        return tensors if keys != [None] else tensors[None]

    def run(self, args) -> torch.Tensor:
        """The program on device inputs (from :meth:`to_device`); the
        predictions stay on the device."""
        with torch.inference_mode():
            return self.module(args)

    def __call__(self, x) -> np.ndarray:
        return self.run(self.to_device(x)).cpu().numpy()


def _parse(blob: bytes) -> tuple[dict, int]:
    if bytes(blob[: len(_JAX_MAGIC)]) == _JAX_MAGIC:
        raise ValueError("this is a JAX serving package (weights-as-arguments StableHLO); load it "
                         "with imbalanced_regression_tpu.serving.load_predictor")
    if bytes(blob[: len(_MAGIC)]) != _MAGIC:
        raise ValueError("not a predictor of imbalanced_regression_tpu_torch.serving (a JAX "
                         "StableHLO artifact? load those with "
                         "imbalanced_regression_tpu.serving.load_predictor)")
    off = len(_MAGIC)
    (n,) = struct.unpack("<Q", blob[off : off + 8])
    return json.loads(bytes(blob[off + 8 : off + 8 + n])), off + 8 + n


def load_predictor(blob: bytes, device: str | torch.device | None = None) -> Predictor:
    """Load the program for ``device`` from an artifact of
    :func:`export_predictor`. ``device`` defaults to ``cuda`` where the
    artifact has a cuda program, else to its one platform; a device it has
    no program for is refused. A cuda program runs on the current CUDA
    device."""
    header, off = _parse(blob)
    platforms = tuple(header["platforms"])
    device = torch.device(device if device is not None else
                          "cuda" if "cuda" in platforms else platforms[0])
    if device.type not in platforms:
        raise ValueError(f"the artifact has no {device.type} program; it was exported for "
                         f"{list(platforms)}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to load the artifact's "
                           "cpu program (if it has one: it was exported for "
                           f"{list(platforms)})")
    k = platforms.index(device.type)
    start = off + sum(header["sizes"][:k])
    with warnings.catch_warnings():
        # some torch versions' archive reader wraps each weight's read-only
        # bytes with torch.frombuffer and warns; the program never writes
        # to its weights
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        program = torch.export.load(io.BytesIO(blob[start : start + header["sizes"][k]]))
    device = _device_of(device.type)
    return Predictor(program.module(), device, platforms, header["inputs"])


def save_predictor(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_predictor_file(path: str, device: str | torch.device | None = None) -> Predictor:
    with open(path, "rb") as f:
        return load_predictor(f.read(), device)
