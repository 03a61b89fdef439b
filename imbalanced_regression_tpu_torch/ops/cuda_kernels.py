"""Hand-written CUDA kernels for the FDS hot ops, with their build and
binding.

Four kernels in ``csrc/`` replace the Pallas TPU kernels of the JAX package
(``imbalanced_regression_tpu/ops/pallas_kernels.py``):

- K1 :func:`calibrate_forward` — fused gather + FDS calibrate
  (``pallas_calibrate`` / ``_calibrate_kernel``; ``fds_kernels.cu``);
- K2 :func:`calibrate_backward` — its gradient in ``x``
  (``_pallas_calibrate_bwd`` / ``_calibrate_bwd_kernel``; ``fds_kernels.cu``);
- K3 :func:`segment_moments` — per-bucket count, sum and sum of squares
  (``pallas_moments`` / ``_moments_kernel``; ``fds_kernels.cu``);
- K4 :func:`segment_moments_v2` — the same moments from a three-term bf16
  split on the tensor cores (``pallas_moments_v2`` / ``_moments_v2_kernel``
  and ``_split3``; ``moments_v2.cu``).

K1 runs in one of two forms, chosen by :func:`calibrate_plan` from the
shapes: direct (each row gathers its bucket's statistics and computes the
factor per element) for small batches, and factored (a first kernel writes
the per-bucket factor table, a second gathers from it) for large ones; K2
runs the direct form. K3
runs one of two kernels, chosen by :func:`moments_plan` from the shapes:
a short-batch kernel for a few thousand rows or fewer, and a row split for
more. The row split, and K4, cut the rows into chunks (:func:`row_chunks`,
:func:`v2_chunks`) and add the chunks' partials in a fixed order, so both
are deterministic.

Each source is compiled with ``nvcc`` for ``sm_90a`` (all at once, one
process per file) and linked into a shared library with a plain C
interface, at first use, into ``imbalanced_regression_tpu_torch/build/``
under a name keyed by a hash of the sources and flags, and loaded with
``ctypes``. Each wrapper launches its kernel on the current CUDA stream for
a CUDA tensor (or raises), and runs the plain PyTorch version only for a
tensor on the CPU. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from imbalanced_regression_tpu_torch.ops.calibrate import calibrate_indexed, calibrate_indexed_grad

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, x_bf16, e, ok, m1, v1, m2, v2, v1sum, out, table, n, d, nb, lo, hi, positive,
    # then the CalibratePlan's launch (cols, block_x, block_y, grid_x, grid_y), stream
    "fds_calibrate_fwd": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I,
                          _I, _I, _I, _I, _I, _P),
    # g, e, ok, v1, v2, v1sum, out, n, d, nb, lo, hi, positive, the launch, stream
    "fds_calibrate_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I,
                          _I, _I, _I, _I, _I, _P),
    # f, f_bf16, idx, counts, sums, sumsq, ws_counts, ws_sums, ws_sumsq, n, d, nb, chunks,
    # kernel, stream
    "fds_segment_moments": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "fds_moments_short_max_rows": (),
    # f, idx, counts, sums, sumsq, ws_counts, ws_sums, ws_sumsq, n, d, nb, chunks, stream
    "fds_segment_moments_v2": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "fds_moments_v2_blocks_per_sm": (),
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
    for src in sorted(SOURCE_DIR.glob("*.cu*")):  # the .cu sources and their .cuh headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfds_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile each ``csrc/*.cu`` to an object, one ``nvcc`` per source, all
    started together, and link them, unless the library for these sources
    exists. The compiler's output (register and shared-memory use per
    kernel) goes to a ``.log`` file beside the library. Raises if the build
    fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    objects = [str(tmp.with_suffix(f".{src.stem}.o")) for src in sources]
    compiles = [[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", obj] for src, obj in zip(sources, objects)]
    log = []
    for step in (compiles, [[_nvcc(), "-shared", "-o", str(tmp), *objects]]):
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in step]
        outputs = [proc.communicate()[0] for proc in procs]
        log += [" ".join(cmd) + "\n" + text for cmd, text in zip(step, outputs)]
        out.with_suffix(".log").write_text("\n".join(log))
        for proc, text in zip(procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{text[-4000:]}")
    for obj in objects:
        os.unlink(obj)
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared. Raises if K3's short-batch kernel
    takes another row count than :func:`moments_plan` sends it, or K4 is
    compiled for another occupancy than :func:`v2_chunks` assumes."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    if lib.fds_moments_short_max_rows() != SHORT_BATCH_MAX_ROWS:
        raise RuntimeError(f"the short-batch kernel takes {lib.fds_moments_short_max_rows()} rows, "
                           f"SHORT_BATCH_MAX_ROWS is {SHORT_BATCH_MAX_ROWS}")
    if lib.fds_moments_v2_blocks_per_sm() != V2_BLOCKS_PER_SM:
        raise RuntimeError(f"K4 is compiled for {lib.fds_moments_v2_blocks_per_sm()} blocks a SM, "
                           f"V2_BLOCKS_PER_SM is {V2_BLOCKS_PER_SM}")
    return lib


def _launch(name: str, device_index: int, *args) -> None:
    """Call entry point ``name`` with ``args`` and the current stream of
    the device, taken as its raw handle (a ``torch.cuda.Stream`` object
    costs several microseconds a call, more than the launch itself at the
    age shapes)."""
    stream = torch._C._cuda_getCurrentRawStream(device_index)
    err = getattr(load_library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return True


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


CALIBRATE_THREADS = 256  # a block's threads (kCalibrateThreads in csrc/fds_kernels.cu)
ROW_TILE_THREADS = 64  # the most threads of a block along a row
# the factored form runs where there are at least this many rows a SM for
# each bucket: its factor kernel (one more launch, a pass over the [B, D]
# statistics) then costs a few percent of the call
FACTORED_ROWS_PER_BUCKET = 8


class CalibratePlan(NamedTuple):
    """How K1/K2 run: ``cols`` columns a thread (4: one 16-byte load; 1:
    where D % 4 != 0 or a pointer is not 16-byte aligned), a block of
    ``block_x`` threads along a row tile by ``block_y`` rows, ``grid_x``
    row blocks by ``grid_y`` row tiles, and ``factored``: K1's factor
    table first (the factored form), else the direct form."""

    cols: int
    block_x: int
    block_y: int
    grid_x: int
    grid_y: int
    factored: bool


@functools.cache
def calibrate_plan(n: int, d: int, nb: int, sm_count: int, bwd: bool = False,
                   vec: bool = True) -> CalibratePlan:
    """K1's (``bwd`` False) or K2's launch plan for ``n`` rows of ``d``
    columns and ``nb`` buckets on a card with ``sm_count`` SMs; ``vec``:
    the pointers are 16-byte aligned. A thread owns ``cols`` columns; a row
    tile is the whole row up to ``ROW_TILE_THREADS`` threads, else the
    widest tile of at least a warp that divides the row (every thread has
    columns), else even tiles (fewer idle threads than tiles). K1 takes the
    factored form from ``FACTORED_ROWS_PER_BUCKET * nb * sm_count`` rows
    on; K2 the direct form at every shape."""
    cols = 4 if vec and d % 4 == 0 else 1
    q = -(-d // cols)  # threads a row
    whole = [w for w in range(32, ROW_TILE_THREADS + 1) if q % w == 0]
    block_x = q if q <= ROW_TILE_THREADS else (
        whole[-1] if whole else -(-q // -(-q // ROW_TILE_THREADS)))
    rows = CALIBRATE_THREADS // block_x
    return CalibratePlan(cols, block_x, rows, -(-n // rows), -(-q // block_x),
                         not bwd and nb > 0 and n >= FACTORED_ROWS_PER_BUCKET * nb * sm_count)


def _calibrate_launch(name: str, x, e, ok, tables, v1sum, head=(), tail=()):
    """Allocate K1/K2's output (and, for K1's factored form, its scratch
    table) and launch entry point ``name`` on ``x`` [N, D] and the float32
    [B, D] ``tables`` (four for K1, two for K2), with ``head`` after x's
    pointer and ``tail`` (lo, hi, positive) before the plan's launch."""
    n, d = x.shape
    nb = v1sum.shape[0]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n * d == 0:
        return out
    ptrs = [t.data_ptr() for t in tables]
    vec = (x.data_ptr() % (4 * x.element_size()) == 0
           and all(p % 16 == 0 for p in (*ptrs, out.data_ptr())))
    dev = x.get_device()
    bwd = len(tables) == 2
    plan = calibrate_plan(n, d, nb, _sm_count(dev), bwd, vec)
    # K1's factored form: the factor, m1 and m2 [B, D], held until the
    # launches are enqueued
    table = torch.empty((3 * nb * d,), dtype=torch.float32, device=x.device) \
        if plan.factored else None
    scratch = () if bwd else (table.data_ptr() if plan.factored else None,)
    _launch(name, dev, x.data_ptr(), *head, e.data_ptr(), ok.data_ptr(), *ptrs,
            v1sum.data_ptr(), out.data_ptr(), *scratch, n, d, nb, *tail, *plan[:5])
    return out


def calibrate_forward(x, e, ok, m1, v1, m2, v2, v1sum, clip_min: float, clip_max: float,
                      mode: str) -> torch.Tensor:
    """K1: ``where(mask, (x - m1[e]) * sqrt(clip(v2[e] / v1[e])) + m2[e], x)``
    for ``x`` [N, D] float32/bf16, ``e`` [N] int32, ``ok`` [N] bool and
    float32 statistics [B, D] with ``v1sum`` [B]; float32 [N, D] out.
    Runs the form :func:`calibrate_plan` picks. Plain version:
    :func:`ops.calibrate.calibrate_indexed`."""
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
    # the entry point takes m1, v1, m2, v2 in this order
    out = _calibrate_launch("fds_calibrate_fwd", x, e, ok, (m1, v1, m2, v2), v1sum,
                            (int(x.dtype == torch.bfloat16),), (clip_min, clip_max, positive))
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
    out = _calibrate_launch("fds_calibrate_bwd", g, e, ok, (v1, v2), v1sum, (),
                            (clip_min, clip_max, positive))
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
# K3 / K4: segment moments
# ---------------------------------------------------------------------------

MIN_CHUNK_ROWS = 1024  # no row chunk of K3/K4 is cut shorter than this


def row_chunks(n: int, col_tiles: int, target_blocks: int) -> int:
    """Row chunks of a segment-moments launch: enough (column tile x chunk)
    blocks to reach ``target_blocks``, but none shorter than
    ``MIN_CHUNK_ROWS`` rows, and at least one. A function of the shapes and
    the card only, so two runs add the same partials in the same order."""
    return max(1, min(-(-n // MIN_CHUNK_ROWS), -(-target_blocks // col_tiles)))


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _onehot(idx, num_buckets: int) -> torch.Tensor:
    """float32 [N, B] one-hot of ``idx``; indices outside [0, B) give a zero row."""
    valid = (idx >= 0) & (idx < num_buckets)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    return F.one_hot(safe, num_buckets).to(torch.float32) * valid[:, None]


def segment_moments_plain(features, idx, num_buckets: int):
    """One-hot contraction: counts [B], sums [B, D], sums of squares [B, D]
    of ``features`` grouped by ``idx`` (indices outside [0, B) are
    ignored), in float32 with TF32 off (the caller's global setting)."""
    f = features.to(torch.float32)
    onehot = _onehot(idx, num_buckets)
    return onehot.sum(0), onehot.T @ f, onehot.T @ (f * f)


def split3(x: torch.Tensor):
    """Three bf16 terms with ``h1 + h2 + h3 == x`` to float32 accuracy, each
    rounded to nearest from the remainder of the ones before (JAX
    ``pallas_kernels._split3``)."""
    h1 = x.to(torch.bfloat16)
    r1 = x - h1.to(torch.float32)
    h2 = r1.to(torch.bfloat16)
    h3 = (r1 - h2.to(torch.float32)).to(torch.bfloat16)
    return h1, h2, h3


def segment_moments_v2_plain(features, idx, num_buckets: int):
    """K4's arithmetic in plain PyTorch: the one-hot times each bf16 term of
    ``split3(f)`` and ``split3(f * f)``, widened to float32 (exactly), with
    float32 accumulation (TF32 off, the caller's global setting), the three
    products of each quantity added as ``(p1 + p2) + p3``."""
    f = features.to(torch.float32)
    onehot = _onehot(idx, num_buckets)

    def contract(x):
        p1, p2, p3 = (onehot.T @ h.to(torch.float32) for h in split3(x))
        return (p1 + p2) + p3

    return onehot.sum(0), contract(f), contract(f * f)


def _moments_launch(name: str, features, idx, num_buckets: int, chunks: int, head=(), tail=()):
    """Allocate the outputs (and, with several row chunks, the workspaces)
    and launch one of the segment-moments entry points with ``head`` after
    the features and ``tail`` after the chunk count. Returns (counts [B],
    sums [B, D], sums of squares [B, D]), views of one buffer."""
    n, d = features.shape
    dev = features.device
    per = num_buckets * d
    # one buffer: sums [B, D], sums of squares [B, D], then counts [B] (last,
    # so the [B, D] blocks keep the buffer's 16-byte alignment)
    out = torch.empty((2 * per + num_buckets,), dtype=torch.float32, device=dev)
    # workspaces: partial sums and sums of squares [chunks, B, D], partial
    # counts [chunks, B]; held until the launches are enqueued (after that
    # the caching allocator hands the block only to later work on this stream)
    ws = torch.empty((chunks * (2 * per + num_buckets),), dtype=torch.float32, device=dev) \
        if chunks > 1 else None

    def pointers(buf, slots):  # counts, sums, sums of squares
        p = buf.data_ptr()
        return p + 8 * slots * per, p, p + 4 * slots * per

    ws_ptrs = pointers(ws, chunks) if ws is not None else (None,) * 3
    _launch(name, features.get_device(), features.data_ptr(), *head, idx.data_ptr(),
            *pointers(out, 1), *ws_ptrs, n, d, num_buckets, chunks, *tail)
    # one split and two views: each tensor op costs microseconds of host
    # time, as much as the launch at the age shapes
    sums, sumsq, counts = out.split_with_sizes((per, per, num_buckets))
    return counts, sums.view(num_buckets, d), sumsq.view(num_buckets, d)


def _check_moments_inputs(features, idx, dtypes) -> None:
    n, d = features.shape
    # what the kernels take, in one expression; only on a mismatch do the
    # checks below run one by one, to name it
    if (d > 0 and features.dtype in dtypes and idx.dtype == torch.int32 and idx.shape == (n,)
            and features.is_contiguous() and idx.is_contiguous()
            and idx.get_device() == features.get_device()):
        return
    _check("features", features, dtypes, (n, d), features.device)
    _check("idx", idx, (torch.int32,), (n,), features.device)
    if d == 0:
        raise ValueError("features need at least one column")


# K3 takes its short-batch kernel up to this many rows, the most indices
# it stages in shared memory (kShortMaxRows in csrc/fds_kernels.cu)
SHORT_BATCH_MAX_ROWS = 4096
_K3_KERNELS = {"short": 0, "split": 1}  # fds_segment_moments' kernel codes


class MomentsPlan(NamedTuple):
    """How K3 runs: ``kernel`` "short" (one pass sized by the batch, for
    ``N <= SHORT_BATCH_MAX_ROWS``) or "split" (the row split), in
    ``chunks`` row chunks (1: no second pass)."""

    kernel: str
    chunks: int


@functools.cache
def moments_plan(n: int, d: int, sm_count: int) -> MomentsPlan:
    """K3's launch plan for ``n`` rows of ``d`` features on a card with
    ``sm_count`` SMs. The buckets and the feature type do not enter it; as
    it depends on nothing else, the order of every sum, and so the bits of
    the result, is the same from call to call."""
    if n <= SHORT_BATCH_MAX_ROWS:
        return MomentsPlan("short", 1)
    # 32-column tiles; one block per SM (a block holds 8 warps' [B, 32]
    # accumulators, ~190 kB of shared memory at B = 93)
    return MomentsPlan("split", row_chunks(n, -(-d // 32), sm_count))


def segment_moments(features, idx, num_buckets: int):
    """K3: per-bucket (count [B], sum [B, D], sum of squares [B, D]) of
    ``features`` [N, D] float32/bf16 grouped by ``idx`` [N] int32; an index
    outside [0, B) (the -1 of padding) is ignored. Runs the kernel
    :func:`moments_plan` picks. Deterministic: two calls on the same inputs
    give the same bits. ``segment_moments.kernels`` counts the launches by
    kernel."""
    if _on_cpu(features):
        return segment_moments_plain(features, idx, num_buckets)
    _check_moments_inputs(features, idx, _FEATURE_DTYPES)
    n, d = features.shape
    plan = moments_plan(n, d, _sm_count(features.get_device()))
    out = _moments_launch("fds_segment_moments", features, idx, num_buckets, plan.chunks,
                          (int(features.dtype == torch.bfloat16),), (_K3_KERNELS[plan.kernel],))
    segment_moments.launches += 1
    segment_moments.kernels[plan.kernel] += 1
    return out


V2_MAX_BUCKETS = 128  # K4 keeps the padded bucket axis in at most 16 tiles of 8
# K4's blocks a SM, the register cap it is compiled for (kMinBlocksPerSM in
# csrc/moments_v2.cu)
V2_BLOCKS_PER_SM = 3


def v2_chunks(n: int, d: int, sm_count: int) -> int:
    """K4's row chunks for ``n`` rows of ``d`` features: as many as one wave
    of ``V2_BLOCKS_PER_SM`` blocks a SM holds over the 16-column tiles
    (rounded down: a block left to a second wave would double the time),
    none shorter than ``MIN_CHUNK_ROWS`` rows, at least one. A function of
    the shapes and the card only, so the bits never change."""
    return max(1, min(-(-n // MIN_CHUNK_ROWS), V2_BLOCKS_PER_SM * sm_count // -(-d // 16)))


def segment_moments_v2(features, idx, num_buckets: int):
    """K4: the contract of :func:`segment_moments` for float32 ``features``,
    computed from a three-term bf16 split on the tensor cores (at most
    ``V2_MAX_BUCKETS`` buckets). Deterministic. Plain version:
    :func:`segment_moments_v2_plain`."""
    if _on_cpu(features):
        return segment_moments_v2_plain(features, idx, num_buckets)
    _check_moments_inputs(features, idx, _F32)
    if not 1 <= num_buckets <= V2_MAX_BUCKETS:
        raise ValueError(f"segment_moments_v2 takes 1 to {V2_MAX_BUCKETS} buckets, got {num_buckets}")
    chunks = v2_chunks(*features.shape, _sm_count(features.get_device()))
    out = _moments_launch("fds_segment_moments_v2", features, idx, num_buckets, chunks)
    segment_moments_v2.launches += 1
    return out


KERNEL_WRAPPERS = (calibrate_forward, calibrate_backward, segment_moments, segment_moments_v2)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    segment_moments.kernels = collections.Counter()


reset_launch_counts()
