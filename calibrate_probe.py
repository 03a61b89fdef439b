"""The measurements behind K1/K2's (FDS calibrate, forward and backward)
design, on one NVIDIA GPU (H100):

    python3 calibrate_probe.py [--baseline DIR] [--variants NAME ...]

At each shape the port runs the calibrate kernels at (the age batch N =
64, the bench's N = 128 and the AgeDB-DIR batch N = 256 at D = 2048; the
NYUD2 step's N = 554,496 pixel rows, also with every row calibrated, and a
rank's 277,248 at D = 128; the STS-B batch N = 128 at D = 12000), K1's and
K2's device time per call in a replayed CUDA graph, with the statistics
cold (``chip_smoke.cold_tables``, as a train step finds them) and warm
(one copy, re-read from L2 call after call), and with cold statistics the
per-call time by CUDA events, beside the bound
(``chip_smoke.calibrate_bytes``):

- ``port``: the form and launch the plan picks (``calibrate_plan``);
- with ``--variants``, the port with one constant of its plan changed
  (``VARIANTS``: K1's direct or factored form at every shape, row tiles of
  up to 256 threads). K2's factored form, timed the same way while the
  design was chosen, was slower than its direct form at the depth rows
  and was taken out;
- ``baseline``, with ``--baseline DIR``: the calibrate kernel of another
  version, built from ``DIR/fds_kernels.cu`` (with the
  ``moments_common.cuh`` it includes) and called through that version's C
  interface, ``fds_calibrate_fwd`` / ``fds_calibrate_bwd`` with no plan or
  table arguments. To compare with the parent commit:
  ``git archive HEAD imbalanced_regression_tpu_torch/csrc | tar -x -C
  runs/base`` then ``--baseline runs/base/imbalanced_regression_tpu_torch/csrc``;
- at the rows of more than 4,096: ``out.copy_(x)``, PyTorch moving the same
  x in and out, a yardstick of what a streaming kernel reaches.

The variants run in turns (baseline, port, the others, then back), and
both readings are printed. Every variant's output is held bit-equal to the
plain version before it is timed. Prints the card's name and power limit
and ptxas's lines for the calibrate kernels, and writes their SASS to
``--sass`` (default ``runs/calibrate_sass.txt``; the order of the loads
can be read there). Exits non-zero with no CUDA device. Changes nothing in
the library the port runs.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as smoke

ROWS = (  # name, N, (D, B), mode, clips, every row in a bucket with its flag set
    ("age", smoke.N_MAIN, smoke.AGE, "nonzero", (0.1, 10.0), False),
    ("bench", smoke.BENCH_BATCH, smoke.AGE, "nonzero", (0.1, 10.0), False),
    ("AgeDB", smoke.AGEDB_BATCH, smoke.AGEDB, "nonzero", (0.1, 10.0), False),
    ("depth", smoke.N_DEPTH, smoke.DEPTH, "positive", (0.2, 5.0), False),
    ("depth, every row on", smoke.N_DEPTH, smoke.DEPTH, "positive", (0.2, 5.0), True),
    ("depth a rank", smoke.N_DEPTH // smoke.DP_RANKS, smoke.DEPTH, "positive", (0.2, 5.0), False),
    ("STS-B", smoke.STS_BATCH, smoke.STS, "positive", (0.5, 2.0), False),
)
# name: (a constant of ops/cuda_kernels.py, its value in the variant)
VARIANTS = {
    "direct": ("FACTORED_ROWS_PER_BUCKET", 2**40),  # K1's direct form at every shape
    "factored": ("FACTORED_ROWS_PER_BUCKET", 0),  # K1's factored form at every shape
    "256-wide tiles": ("ROW_TILE_THREADS", 256),
}


@contextlib.contextmanager
def variant(ck, name: str):
    """The port with ``VARIANTS[name]``'s constant changed in its plan."""
    constant, value = VARIANTS[name]
    old = getattr(ck, constant)
    setattr(ck, constant, value)
    ck.calibrate_plan.cache_clear()
    try:
        yield
    finally:
        setattr(ck, constant, old)
        ck.calibrate_plan.cache_clear()


def baseline_variant(ck, src: Path, sass: Path):
    """K1 and K2 of the version in ``src``, built into the build directory
    and called through its C interface (no plan arguments)."""
    lib_path = ck.BUILD_DIR / "calibrate_baseline" / "libcalibrate_baseline.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(src / "fds_kernels.cu")], check=True, capture_output=True)
    write_sass(lib_path, "baseline", sass)
    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fds_calibrate_fwd.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, i, f, f, i, p]
    lib.fds_calibrate_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, f, f, i, p]

    def call(name, x, head, e, ok, tables, v1sum, clips, mode):
        n, d = x.shape
        out = torch.empty((n, d), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(x.data_ptr(), *head, e.data_ptr(), ok.data_ptr(),
                                 *(t.data_ptr() for t in tables), v1sum.data_ptr(),
                                 out.data_ptr(), n, d, v1sum.shape[0], *clips,
                                 int(mode == "positive"), stream)
        assert err == 0, f"{name}: CUDA error {err}"
        return out

    def fwd(x, e, ok, m1, v1, m2, v2, v1sum, lo, hi, mode):
        return call("fds_calibrate_fwd", x, (int(x.dtype == torch.bfloat16),), e, ok,
                    (m1, v1, m2, v2), v1sum, (lo, hi), mode)

    def bwd(g, e, ok, v1, v2, v1sum, lo, hi, mode):
        return call("fds_calibrate_bwd", g, (), e, ok, (v1, v2), v1sum, (lo, hi), mode)

    return fwd, bwd


def log_build(ck, sass: Path) -> None:
    lines = ck.library_path().with_suffix(".log").read_text().splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry" in line and "calibrate" in line:
            smoke.log(f"ptxas: {line.strip()}")
            for follow in lines[k + 1:k + 4]:
                if "registers" in follow or "spill" in follow:
                    smoke.log(f"ptxas:   {follow.strip()}")
    write_sass(ck.library_path(), "port", sass)


def write_sass(lib: Path, tag: str, sass_out: Path) -> None:
    """Append the SASS of the calibrate kernels in ``lib`` to ``sass_out``."""
    from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck

    sass = subprocess.run([str(Path(ck._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    keep, out = False, [f"==== {tag}: {lib}"]
    for line in sass.splitlines():
        if "Function :" in line:
            keep = "calibrate" in line
        if keep:
            out.append(line)
    sass_out.parent.mkdir(parents=True, exist_ok=True)
    with sass_out.open("a") as f:
        f.write("\n".join(out) + "\n")
    smoke.log(f"SASS of the {tag} calibrate kernels: {len(out)} lines in {sass_out}")


def probe_row(ck, cal, gen, dev, variants, name, n, d, b, mode, clips, all_on) -> None:
    x, e, ok, stats, v1sum = smoke.calibrate_inputs(gen, dev, n, d, b, sts_corners=name == "STS-B")
    if all_on:  # every row in a bucket with its flag set, as most pixels of a depth map are
        e, ok = e.clamp(0, b - 1), torch.ones_like(ok)
    g = torch.randn(n, d, generator=gen, device=dev)
    bound_of = {}
    for kernel, tables in (("K1", 4), ("K2", 2)):
        nbytes, elems = smoke.calibrate_bytes(4, e, ok, v1sum, d, tables=tables)
        bound_of[kernel] = smoke.bound(nbytes, (8 if tables == 4 else 6) * elems)[0]
    want = {"K1": cal.calibrate_indexed(x, e, ok, *stats, v1sum, *clips, mode),
            "K2": cal.calibrate_indexed_grad(g, e, ok, stats[1], stats[3], v1sum, *clips, mode)}
    order = list(variants) + list(reversed(variants))
    readings = {(k, v): [] for k in ("K1", "K2") for v in variants}
    for name_ in order:
        fwd, bwd, ctx = variants[name_]
        with ctx():
            calls = {
                "K1": (lambda *t: fwd(x, e, ok, *t, *clips, mode), (*stats, v1sum)),
                "K2": (lambda *t: bwd(g, e, ok, *t, *clips, mode), (stats[1], stats[3], v1sum)),
            }
            for kernel, (fn, tables) in calls.items():
                got = fn(*tables)
                torch.cuda.synchronize()
                assert torch.equal(got, want[kernel]), f"{kernel} {name_} {name}: not bit-equal"
                cold, graph_iters = smoke.cold_tables(fn, tables)
                readings[kernel, name_].append(
                    (smoke.graph_ms(cold, graph_iters), smoke.graph_ms(lambda: fn(*tables)),
                     smoke.time_ms(cold, 10 if n > 4096 else 50)))
    if n > 4096:  # PyTorch's copy of the same x in and out, a yardstick for a streaming kernel
        out = torch.empty_like(x)
        cb = 2 * x.numel() * x.element_size()
        times = [smoke.graph_ms(lambda: out.copy_(x)) for _ in range(2)]
        smoke.log(f"copy {name} N={n} D={d}: out.copy_(x), {cb} bytes: device "
                  + " / ".join(f"{t:.5f} ({100 * cb / smoke.HBM_BYTES_PER_S * 1e3 / t:.1f}% of "
                               f"the byte rate)" for t in times))
    for (kernel, name_), rs in readings.items():
        bd = bound_of[kernel]
        text = " / ".join(f"cold {c:.5f} ({100 * bd / c:.1f}% of bound), warm {w:.5f} "
                          f"({100 * bd / w:.1f}%), ms {m:.4f}" for c, w, m in rs)
        smoke.log(f"{kernel} {name} N={n} D={d} B={b} {name_}: device {text}; bound {bd:.5f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--baseline", type=Path, default=None,
                   help="a directory with another version's fds_kernels.cu and moments_common.cuh")
    p.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS),
                   help="variants of the port's plan to time beside it")
    p.add_argument("--sass", type=Path, default=Path("runs/calibrate_sass.txt"),
                   help="where the calibrate kernels' SASS is written")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_probe: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smoke.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
    from imbalanced_regression_tpu_torch.ops import calibrate as cal
    from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
    from imbalanced_regression_tpu_torch.train import set_numerics

    set_numerics()
    args.sass.unlink(missing_ok=True)
    ck.load_library()
    log_build(ck, args.sass)
    dev = torch.device("cuda:0")
    variants = {"baseline": (*baseline_variant(ck, args.baseline, args.sass),
                             contextlib.nullcontext)} \
        if args.baseline else {}
    variants["port"] = (ck.calibrate_forward, ck.calibrate_backward, contextlib.nullcontext)
    for v in args.variants:
        variants[v] = (ck.calibrate_forward, ck.calibrate_backward, lambda v=v: variant(ck, v))
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, n, (d, b), mode, clips, all_on in ROWS:
        smoke.log(f"{name} N={n} D={d} B={b}: K1 plan {ck.calibrate_plan(n, d, b, sm)}, K2 plan "
                  f"{ck.calibrate_plan(n, d, b, sm, True)}")
        probe_row(ck, cal, gen, dev, variants, name, n, d, b, mode, clips, all_on)
    return 0


if __name__ == "__main__":
    sys.exit(main())
