"""The measurements behind K3's (segment moments) design choices, on one
NVIDIA GPU (H100):

    python3 k3_probe.py

1. threshold: K3's short-batch kernel against its row split at D = 2048,
   B = 100 (the age encoding) for N from the age batch up to the short
   kernel's limit, where ``SHORT_BATCH_MAX_ROWS`` is chosen; the row split
   is forced by setting that threshold below N;
2. host cost at the age batch (N = 64): the wrapper, its output allocation,
   its launch helper (allocation and the ctypes call), ``index_add_`` with
   its ``torch.zeros``, the zeros alone, and the device times of K3 and
   ``index_add_``;
3. rows in flight: the row split at the NYUD2 stats-pass shape with the 32
   rows a warp loads before it adds them, and with 16, from a library built
   from a copy of ``csrc/`` with that constant changed; on a random index
   and on one in runs along 152-pixel rows.

Every K3 result is held against its plain version (1, 2) or a float64
reference (3) before it is timed. Prints the card's name and power limit,
then one line per measurement. Exits non-zero with no CUDA device. Changes
nothing in the library the port runs.
"""

from __future__ import annotations

import contextlib
import shutil
import subprocess
import sys

import torch

import chip_smoke as smoke

ROWS_CONSTANT = "constexpr int kSplitRowsInFlight = 32;"


@contextlib.contextmanager
def patched(module, reload: bool = False, **values):
    """Set ``module``'s attributes to ``values`` (with K3's plan and, with
    ``reload``, the library loaded anew under them), and restore them
    after."""
    old = {k: getattr(module, k) for k in values}

    def clear():
        module.moments_plan.cache_clear()
        if reload:
            module.load_library.cache_clear()

    try:
        for k, v in values.items():
            setattr(module, k, v)
        clear()
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)
        clear()


def threshold(ck, gen, dev) -> None:
    d, b = smoke.AGE
    for n in (64, 256, 1024, 2048, 4096):
        f, idx = smoke.moments_inputs(gen, dev, n, d, b)
        want = ck.segment_moments_plain(f, idx, b)
        line = []
        # the row split below the threshold: a threshold of -1 sends every N
        # to it (the library, loaded already, is not checked against it)
        for kernel, ctx in (("short", contextlib.nullcontext()),
                            ("split", patched(ck, SHORT_BATCH_MAX_ROWS=-1))):
            with ctx:
                ck.segment_moments.kernels.clear()
                got = ck.segment_moments(f, idx, b)
                assert ck.segment_moments.kernels == {kernel: 1}, ck.segment_moments.kernels
                torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
                for a, w in zip(got[1:], want[1:]):
                    torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
                call = lambda: ck.segment_moments(f, idx, b)  # noqa: E731
                line.append(f"{kernel} ms {smoke.time_ms(call):.4f} "
                            f"(device {smoke.graph_ms(call):.4f})")
        library = smoke.time_ms(smoke.library_moments(f, idx, b))
        smoke.log(f"K3 kernels N={n} D={d} B={b}: {', '.join(line)}, index_add_ ms {library:.4f}")


def host_cost(ck, gen, dev) -> None:
    n, (d, b) = smoke.N_MAIN, smoke.AGE
    f, idx = smoke.moments_inputs(gen, dev, n, d, b)
    per = b * d
    plan = ck.moments_plan(n, d, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.kernel == "short", plan
    library = smoke.library_moments(f, idx, b)
    parts = {
        "wrapper": lambda: ck.segment_moments(f, idx, b),
        "outputs": lambda: [t.view(b, d) for t in torch.empty(2 * per + b, device=dev)
                            .split_with_sizes((per, per, b))[:2]],
        "launch helper": lambda: ck._moments_launch(
            "fds_segment_moments", f, idx, b, plan.chunks, (0,), (ck._K3_KERNELS[plan.kernel],)),
        "index_add_": library,
        "zeros": lambda: torch.zeros(b, 2 * d + 1, device=dev),
    }
    want = ck.segment_moments_plain(f, idx, b)
    for got in (parts["wrapper"](), parts["launch helper"]()):
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5 * float(want[1].abs().max()))
    line = ", ".join(f"{k} {smoke.time_ms(fn, 200):.4f}" for k, fn in parts.items())
    smoke.log(f"K3 host cost N={n} D={d} B={b} (ms per call): {line}; device: K3 "
              f"{smoke.graph_ms(parts['wrapper']):.4f}, index_add_ {smoke.graph_ms(library):.4f}")


def rows_in_flight(ck, gen, dev) -> None:
    n, (d, b) = smoke.N_DEPTH, smoke.DEPTH
    f, idx = smoke.moments_inputs(gen, dev, n, d, b)
    inputs = (("random", idx), ("runs", smoke.run_idx(gen, dev, n, b)))
    variant = ck.BUILD_DIR / "k3_rows16"
    shutil.rmtree(variant, ignore_errors=True)
    shutil.copytree(ck.SOURCE_DIR, variant / "csrc")
    src = variant / "csrc" / "fds_kernels.cu"
    text = src.read_text()
    assert text.count(ROWS_CONSTANT) == 1, f"{ROWS_CONSTANT!r} not found in {src}"
    src.write_text(text.replace(ROWS_CONSTANT, ROWS_CONSTANT.replace("32", "16")))
    lines = {pattern: [] for pattern, _ in inputs}
    for rows, ctx in ((32, contextlib.nullcontext()),
                      (16, patched(ck, reload=True, SOURCE_DIR=variant / "csrc", BUILD_DIR=variant))):
        with ctx:
            for pattern, idx_ in inputs:
                call = lambda i=idx_: ck.segment_moments(f, i, b)  # noqa: E731
                smoke.check_against_float64(f"K3 rows={rows} idx={pattern}", call(),
                                            smoke.float64_moments(f, idx_, b))
                lines[pattern].append(f"{rows} rows in flight: ms {smoke.time_ms(call, 10):.4f} "
                                      f"(device {smoke.graph_ms(call):.4f})")
    for pattern, line in lines.items():
        smoke.log(f"K3 split N={n} D={d} B={b} idx={pattern}: {', '.join(line)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smoke.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
    from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
    from imbalanced_regression_tpu_torch.train import set_numerics

    set_numerics()
    ck.load_library()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    threshold(ck, gen, dev)
    host_cost(ck, gen, dev)
    rows_in_flight(ck, gen, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
