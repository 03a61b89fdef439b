"""The process around a run: when it started, where caches go, which
device it runs on, what it may not have loaded."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

# top-level module names that no run may load: JAX, its libraries, and the
# JAX package the port was made from (compared whole: the port's own name
# begins with the JAX package's)
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "imbalanced_regression_tpu"})


def process_start_time() -> float:
    """The process's start on the ``time.time()`` clock, from ``/proc``
    (the kernel's boot time plus the process's start in clock ticks)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat", encoding="ascii") as fh:
            boot = next(int(line.split()[1]) for line in fh if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, StopIteration, ValueError, IndexError):
        return time.time()


def fix_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds. The program's own K1-K4 library
    builds into ``imbalanced_regression_tpu_torch/build/``, which is in the
    checkout too."""
    cache = root / ".benchcache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN_MODULES)


class NoDevice(RuntimeError):
    pass


def check_cuda(chips: int) -> None:
    """Raise :class:`NoDevice` unless CUDA has at least ``chips`` cards: a
    run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, CUDA has {torch.cuda.device_count()}")


def card_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"
