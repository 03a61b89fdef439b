"""The measurement behind K4's (split-precision segment moments) design
choice, on one NVIDIA GPU (H100):

    python3 k4_probe.py

Steps loaded ahead: K4 at the NYUD2 stats-pass shape (N = 554,496, D = 128,
B = 93) with the one 16-row step a warp loads ahead of the step it
multiplies (``kAhead = 1``), and with two, from a library built from a copy
of ``csrc/`` with that constant changed; on a random index and on one in
runs along 152-pixel rows, in the order 1, 2, 2, 1.

Every result is held against a float64 reference before it is timed.
Prints the card's name and power limit, the compiler's register and spill
lines of K4's depth instance in each build, then one line per measurement.
Exits non-zero with no CUDA device. Changes nothing in the library the port
runs.
"""

from __future__ import annotations

import contextlib
import shutil
import subprocess
import sys

import torch

import chip_smoke as smoke
from k3_probe import patched

AHEAD_CONSTANT = "constexpr int kAhead = 1;"


def variant_library(ck, ahead: int):
    """A context in which ``ck`` runs K4 with ``kAhead = ahead`` (1: the
    library as it is)."""
    if ahead == 1:
        return contextlib.nullcontext()
    variant = ck.BUILD_DIR / f"k4_ahead{ahead}"
    if not (variant / "csrc").exists():  # made once, built at its first use
        shutil.copytree(ck.SOURCE_DIR, variant / "csrc")
        src = variant / "csrc" / "moments_v2.cu"
        text = src.read_text()
        assert text.count(AHEAD_CONSTANT) == 1, f"{AHEAD_CONSTANT!r} not found in {src}"
        src.write_text(text.replace(AHEAD_CONSTANT, AHEAD_CONSTANT.replace("1", str(ahead))))
    return patched(ck, reload=True, SOURCE_DIR=variant / "csrc", BUILD_DIR=variant)


def log_registers(ck, ahead: int) -> None:
    """ptxas's spill and register lines for K4's instances with 12 bucket
    tiles (B = 93), scalar and vector loads."""
    lines = ck.library_path().with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "moments_v2_kernelILi12E" in line:
            vec = "Lb1E" in line
            for follow in lines[i + 2:i + 4]:  # after the "Function properties" line
                smoke.log(f"kAhead={ahead} vector loads={vec} ptxas: {follow.strip()}")


def steps_ahead(ck, gen, dev) -> None:
    n, (d, b) = smoke.N_DEPTH, smoke.DEPTH
    f, idx = smoke.moments_inputs(gen, dev, n, d, b)
    inputs = (("random", idx), ("runs", smoke.run_idx(gen, dev, n, b)))
    refs = {pattern: smoke.float64_moments(f, i, b) for pattern, i in inputs}
    lines = {pattern: [] for pattern, _ in inputs}
    for turn, ahead in enumerate((1, 2, 2, 1)):
        with variant_library(ck, ahead):
            ck.load_library()
            if turn < 2:
                log_registers(ck, ahead)
            for pattern, idx_ in inputs:
                call = lambda i=idx_: ck.segment_moments_v2(f, i, b)  # noqa: E731
                smoke.check_against_float64(f"K4 kAhead={ahead} idx={pattern}", call(), refs[pattern])
                lines[pattern].append(f"kAhead={ahead}: ms {smoke.time_ms(call, 10):.4f} "
                                      f"(device {smoke.graph_ms(call):.4f})")
    for pattern, line in lines.items():
        smoke.log(f"K4 N={n} D={d} B={b} idx={pattern}: {', '.join(line)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smoke.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
    from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
    from imbalanced_regression_tpu_torch.train import set_numerics

    set_numerics()
    dev = torch.device("cuda:0")
    shutil.rmtree(ck.BUILD_DIR / "k4_ahead2", ignore_errors=True)
    steps_ahead(ck, torch.Generator(device=dev).manual_seed(0), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
