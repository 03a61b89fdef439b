"""Hand-written CUDA kernels for the FDS hot ops, with their build and
binding.

Three kernels in ``csrc/fds_kernels.cu`` replace the Pallas TPU kernels of
the JAX package (``imbalanced_regression_tpu/ops/pallas_kernels.py``):

- K1 :func:`calibrate_forward` — fused gather + FDS calibrate
  (``pallas_calibrate`` / ``_calibrate_kernel``);
- K2 :func:`calibrate_backward` — its gradient in ``x``
  (``_pallas_calibrate_bwd`` / ``_calibrate_bwd_kernel``);
- K3 :func:`segment_moments` — per-bucket count, sum and sum of squares
  (``pallas_moments`` / ``_moments_kernel``).

The split-precision moments kernel (``pallas_moments_v2``) is not ported
yet.

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``imbalanced_regression_tpu_torch/
build/`` under a name keyed by a hash of the sources and flags, and loaded
with ``ctypes``. Each wrapper launches its kernel on the current CUDA stream
for a CUDA tensor (or raises), and runs the plain PyTorch version only for a
tensor on the CPU. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from imbalanced_regression_tpu_torch.ops.calibrate import calibrate_indexed, calibrate_indexed_grad

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, x_bf16, e, ok, m1, v1, m2, v2, v1sum, out, n, d, nb, lo, hi, positive, stream
    "fds_calibrate_fwd": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P),
    # g, e, ok, v1, v2, v1sum, out, n, d, nb, lo, hi, positive, stream
    "fds_calibrate_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P),
    # f, f_bf16, idx, counts, sums, sumsq, n, d, nb, stream
    "fds_segment_moments": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path() -> Path:
    """Where the library built from the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfds_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    The compiler's output (register and shared-memory use per kernel) goes
    to a ``.log`` file beside the library. Raises if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(SOURCE_DIR.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, *args) -> None:
    err = getattr(load_library(), name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check(name: str, t: torch.Tensor, dtypes, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_FEATURE_DTYPES = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)


def _mode_flag(mode: str) -> int:
    if mode not in ("nonzero", "positive"):
        raise ValueError(f"mode must be 'nonzero' or 'positive', got {mode!r}")
    return int(mode == "positive")


# ---------------------------------------------------------------------------
# K1 / K2: calibrate
# ---------------------------------------------------------------------------


def calibrate_forward(x, e, ok, m1, v1, m2, v2, v1sum, clip_min: float, clip_max: float,
                      mode: str) -> torch.Tensor:
    """K1: ``where(mask, (x - m1[e]) * sqrt(clip(v2[e] / v1[e])) + m2[e], x)``
    for ``x`` [N, D] float32/bf16, ``e`` [N] int32, ``ok`` [N] bool and
    float32 statistics [B, D] with ``v1sum`` [B]; float32 [N, D] out.
    Plain version: :func:`ops.calibrate.calibrate_indexed`."""
    if _on_cpu(x):
        return calibrate_indexed(x, e, ok, m1, v1, m2, v2, v1sum, clip_min, clip_max, mode)
    positive = _mode_flag(mode)
    n, d = x.shape
    b = m1.shape[0]
    dev = x.device
    _check("x", x, _FEATURE_DTYPES, (n, d), dev)
    _check("e", e, (torch.int32,), (n,), dev)
    _check("ok", ok, (torch.bool,), (n,), dev)
    for name, t in (("m1", m1), ("v1", v1), ("m2", m2), ("v2", v2)):
        _check(name, t, _F32, (b, d), dev)
    _check("v1sum", v1sum, _F32, (b,), dev)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    _launch("fds_calibrate_fwd", x.data_ptr(), int(x.dtype == torch.bfloat16), e.data_ptr(),
            ok.data_ptr(), m1.data_ptr(), v1.data_ptr(), m2.data_ptr(), v2.data_ptr(),
            v1sum.data_ptr(), out.data_ptr(), n, d, b, clip_min, clip_max, positive)
    calibrate_forward.launches += 1
    return out


def calibrate_backward(g, e, ok, v1, v2, v1sum, clip_min: float, clip_max: float,
                       mode: str) -> torch.Tensor:
    """K2: ``g * where(mask, sqrt(clip(v2[e] / v1[e])), 1)`` for ``g``
    [N, D] float32. Plain version: :func:`ops.calibrate.calibrate_indexed_grad`."""
    if _on_cpu(g):
        return calibrate_indexed_grad(g, e, ok, v1, v2, v1sum, clip_min, clip_max, mode)
    positive = _mode_flag(mode)
    n, d = g.shape
    b = v1.shape[0]
    dev = g.device
    _check("g", g, _F32, (n, d), dev)
    _check("e", e, (torch.int32,), (n,), dev)
    _check("ok", ok, (torch.bool,), (n,), dev)
    _check("v1", v1, _F32, (b, d), dev)
    _check("v2", v2, _F32, (b, d), dev)
    _check("v1sum", v1sum, _F32, (b,), dev)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    _launch("fds_calibrate_bwd", g.data_ptr(), e.data_ptr(), ok.data_ptr(), v1.data_ptr(),
            v2.data_ptr(), v1sum.data_ptr(), out.data_ptr(), n, d, b, clip_min, clip_max,
            positive)
    calibrate_backward.launches += 1
    return out


class FDSCalibrate(torch.autograd.Function):
    """Differentiable FDS calibration: forward K1, backward K2. Only ``x``
    gets a gradient; the statistics, ``e`` and ``ok`` get none, as in the
    JAX custom VJP (``pallas_kernels.py:331-339``)."""

    @staticmethod
    def forward(ctx, x, e, ok, m1, v1, m2, v2, v1sum, clip_min, clip_max, mode):
        ctx.save_for_backward(e, ok, v1, v2, v1sum)
        ctx.params = (clip_min, clip_max, mode)
        return calibrate_forward(x, e, ok, m1, v1, m2, v2, v1sum, clip_min, clip_max, mode)

    @staticmethod
    def backward(ctx, g):
        e, ok, v1, v2, v1sum = ctx.saved_tensors
        dx = calibrate_backward(g.contiguous(), e, ok, v1, v2, v1sum, *ctx.params)
        return (dx,) + (None,) * 10


# ---------------------------------------------------------------------------
# K3: segment moments
# ---------------------------------------------------------------------------


def segment_moments_plain(features, idx, num_buckets: int):
    """One-hot contraction: counts [B], sums [B, D], sums of squares [B, D]
    of ``features`` grouped by ``idx`` (indices outside [0, B) are
    ignored), in float32 with TF32 off (the caller's global setting)."""
    f = features.to(torch.float32)
    valid = (idx >= 0) & (idx < num_buckets)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    onehot = F.one_hot(safe, num_buckets).to(torch.float32) * valid[:, None]
    return onehot.sum(0), onehot.T @ f, onehot.T @ (f * f)


def segment_moments(features, idx, num_buckets: int):
    """K3: per-bucket (count [B], sum [B, D], sum of squares [B, D]) of
    ``features`` [N, D] float32/bf16 grouped by ``idx`` [N] int32; an index
    outside [0, B) (the -1 of padding) is ignored. Deterministic: two calls
    on the same inputs give the same bits."""
    if _on_cpu(features):
        return segment_moments_plain(features, idx, num_buckets)
    n, d = features.shape
    dev = features.device
    _check("features", features, _FEATURE_DTYPES, (n, d), dev)
    _check("idx", idx, (torch.int32,), (n,), dev)
    if d == 0:
        raise ValueError("features need at least one column")
    counts = torch.empty((num_buckets,), dtype=torch.float32, device=dev)
    sums = torch.empty((num_buckets, d), dtype=torch.float32, device=dev)
    sumsq = torch.empty((num_buckets, d), dtype=torch.float32, device=dev)
    _launch("fds_segment_moments", features.data_ptr(), int(features.dtype == torch.bfloat16),
            idx.data_ptr(), counts.data_ptr(), sums.data_ptr(), sumsq.data_ptr(), n, d,
            num_buckets)
    segment_moments.launches += 1
    return counts, sums, sumsq


KERNEL_WRAPPERS = (calibrate_forward, calibrate_backward, segment_moments)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()
