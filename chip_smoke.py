"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # every phase, as CI on the card runs it
    python3 chip_smoke.py --profile  # adds a profiled window of train steps

``--profile`` is a measurement tool for ``PERF.md``'s step breakdown; no
check reads it.

Phases:
1. build the CUDA kernels from ``imbalanced_regression_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's batch (N = 64 rows, D = 2048, B = 100 buckets), where both
   are timed, and at N = 128 (K3 also at N = 8192);
3. drive the port's main path, the age train path (``tasks/age.py``: ResNet-50
   in bf16 + LDS + FDS, three epochs on synthetic 224x224 images), with the
   kernel launch counters set to 0 just before and read just after.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and as
the last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
D, B = 2048, 100  # ResNet-50 encoding width, age buckets
MAIN_ARGV = ["--synthetic_size", "640", "--img_size", "224", "--batch_size", "64",
             "--epoch", "3", "--fds", "--lds", "--reweight", "sqrt_inv", "--save_ckpt", "0",
             "--model", "resnet50", "--store_root", "runs/chip_smoke"]
N_MAIN = int(MAIN_ARGV[MAIN_ARGV.index("--batch_size") + 1])  # rows per kernel call on the path
SOURCE = "imbalanced_regression_tpu_torch/csrc/fds_kernels.cu"
PALLAS = "imbalanced_regression_tpu/ops/pallas_kernels.py"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean per-call time of ``iters``
    back-to-back calls, by CUDA events (host launch cost included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def graph_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in a CUDA graph and
    replayed, so host launch cost is out of the measurement."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=1, repeats=repeats) / iters


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def calibrate_inputs(gen: torch.Generator, dev, n: int):
    """Random FDS statistics with the corner cases of the JAX tests: an
    all-zero v1 row, a zero v1 column, a negative v2, ratios beyond the
    clip range, rows with ok=False and rows with e=-1."""
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    x = r(n, D)
    e = torch.randint(0, B, (n,), generator=gen, device=dev, dtype=torch.int32)
    e[:4] = -1
    e[4:8] = 2  # rows of the all-zero v1 bucket
    ok = torch.rand(n, generator=gen, device=dev) > 0.2
    m1, m2 = r(B, D), r(B, D)
    v1, v2 = u(0.01, 3.0, B, D), u(0.01, 3.0, B, D)
    v1[2] = 0.0
    v1[5, 3] = 0.0
    v2[6, 1] = -1.0
    v2[7, :64] = 100.0
    return x, e, ok, (m1, v1, m2, v2), v1.sum(1)


def calibrate_bytes(x_elt: int, e, ok, v1sum, tables: int) -> tuple[float, int]:
    """Bytes the calibrate function must move on these inputs: x in, out,
    e and ok, and for the rows it calibrates the distinct bucket rows of
    ``tables`` [B, D] tables plus their v1sum entries. Returns (bytes,
    calibrated elements)."""
    n = e.numel()
    valid = (e >= 0) & (e < B)
    on = valid & ok & (v1sum[e.clamp(min=0).long()] >= 1e-10)
    buckets = torch.unique(e[on]).numel()
    rows_on = int(on.sum())
    nbytes = n * D * x_elt + n * D * 4 + n * 4 + n + buckets * (tables * D * 4 + 4)
    return nbytes, rows_on * D


def timed(kernel, plain, library, nbytes: float, flops: float, err: float) -> dict:
    return dict(max_abs_err=err, ms=time_ms(kernel), device_ms=graph_ms(kernel),
                plain_ms=time_ms(plain), library_ms=time_ms(library) if library else None,
                bound=bound(nbytes, flops), bytes=nbytes)


def check_calibrate(ck, cal, gen, dev, n: int, record: bool) -> dict:
    """K1 and K2 against their plain versions at ``n`` rows; with
    ``record``, their times and bounds too."""
    results = {}
    x, e, ok, stats, v1sum = calibrate_inputs(gen, dev, n)
    # ---- K1 forward, both guard modes, float32 and bf16 input
    for mode, clips in (("nonzero", (0.1, 10.0)), ("positive", (0.5, 2.0))):
        for xs in (x, x.to(torch.bfloat16)):
            args = (xs, e, ok, *stats, v1sum, *clips, mode)
            got, want = ck.calibrate_forward(*args), cal.calibrate_indexed(*args)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"K1 calibrate_forward N={n} mode={mode} x={xs.dtype}: max_abs_err {err:.3e}")
            # IEEE division/sqrt and unfused mul/add, same order: 1e-6
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if record:
        args = (x, e, ok, *stats, v1sum, 0.1, 10.0, "nonzero")
        nbytes, elems = calibrate_bytes(4, e, ok, v1sum, tables=4)
        results["calibrate_forward"] = dict(
            replaces=f"{PALLAS}:208",
            **timed(lambda: ck.calibrate_forward(*args), lambda: cal.calibrate_indexed(*args),
                    None, nbytes, 8 * elems,
                    max_err(ck.calibrate_forward(*args), cal.calibrate_indexed(*args))))

    # ---- K2 backward against autograd of the plain version
    g = torch.randn(n, D, generator=gen, device=dev)
    for mode, clips in (("nonzero", (0.1, 10.0)), ("positive", (0.5, 2.0))):
        xg = x.clone().requires_grad_(True)
        out = cal.calibrate_indexed(xg, e, ok, *stats, v1sum, *clips, mode)
        (want,) = torch.autograd.grad(out, xg, g)
        got = ck.calibrate_backward(g, e, ok, stats[1], stats[3], v1sum, *clips, mode)
        torch.cuda.synchronize()
        log(f"K2 calibrate_backward N={n} mode={mode}: max_abs_err {max_err(got, want):.3e}")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if record:
        bargs = (g, e, ok, stats[1], stats[3], v1sum, 0.1, 10.0, "nonzero")
        nbytes, elems = calibrate_bytes(4, e, ok, v1sum, tables=2)
        results["calibrate_backward"] = dict(
            replaces=f"{PALLAS}:236",
            **timed(lambda: ck.calibrate_backward(*bargs),
                    lambda: cal.calibrate_indexed_grad(*bargs), None, nbytes, 6 * elems,
                    max_err(ck.calibrate_backward(*bargs), cal.calibrate_indexed_grad(*bargs))))
    return results


def check_moments(ck, gen, dev, n: int, record: bool) -> dict:
    """K3 against its plain version at ``n`` rows, and two runs
    bit-identical; with ``record``, its times and bound too."""
    f = torch.randn(n, D, generator=gen, device=dev) * 3.0 + 1.0
    idx = torch.randint(0, B, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx[::9] = -1
    got = ck.segment_moments(f, idx, B)
    again = ck.segment_moments(f, idx, B)
    want = ck.segment_moments_plain(f, idx, B)
    torch.cuda.synchronize()
    errs = [max_err(a, b) for a, b in zip(got, want)]
    identical = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"K3 segment_moments N={n}: count err {errs[0]:.1e}, sum err {errs[1]:.3e}, "
        f"sumsq err {errs[2]:.3e}, bit-identical across two runs: {identical}")
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)  # counts exact
    # float32 sums in another order than the one-hot matmul: 1e-5
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    assert identical, "segment moments differ between two runs"
    log(f"K3 N={n}: ms {time_ms(lambda: ck.segment_moments(f, idx, B)):.4f}, "
        f"plain_ms {time_ms(lambda: ck.segment_moments_plain(f, idx, B)):.4f}")
    if not record:
        return {}
    valid = idx >= 0
    src = torch.cat([f[valid], f[valid] * f[valid], torch.ones_like(f[valid, :1])], 1)
    tgt = idx[valid].long()

    def library():  # the same sums by one PyTorch call (atomics)
        return torch.zeros(B, 2 * D + 1, device=dev).index_add_(0, tgt, src)

    torch.testing.assert_close(library()[:, :D], want[1], rtol=1e-5, atol=1e-5)
    nbytes = n * D * 4 + n * 4 + B * 4 + 2 * B * D * 4
    return {"segment_moments": dict(
        replaces=f"{PALLAS}:50",
        **timed(lambda: ck.segment_moments(f, idx, B), lambda: ck.segment_moments_plain(f, idx, B),
                library, nbytes, 3 * int(valid.sum()) * D, max(errs)))}


def kernel_phase(ck, cal, dev) -> dict:
    """Every kernel against its plain version at the main path's batch
    (N_MAIN rows, where the records for the ``kernels`` line are taken), at
    N = 128, and K3 also at N = 8192."""
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for n in (N_MAIN, 128):
        results.update(check_calibrate(ck, cal, gen, dev, n, record=n == N_MAIN))
    for n in (N_MAIN, 128, 8192):
        results.update(check_moments(ck, gen, dev, n, record=n == N_MAIN))
    for name, r in results.items():
        log(f"{name} N={N_MAIN}: ms {r['ms']:.4f} (device {r['device_ms']:.4f}), plain_ms "
            f"{r['plain_ms']:.4f}, library_ms {r['library_ms']}, bound_ms {r['bound'][0]:.5f} "
            f"({r['bound'][1]}, {r['bytes']} bytes)")
    return results


def main_path_phase(ck) -> dict:
    from imbalanced_regression_tpu_torch.tasks import age

    ck.reset_launch_counts()
    t0 = time.time()
    result = age.main(MAIN_ARGV)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}
    log(f"main path: {time.time() - t0:.1f}s, kernel launches {launches}")
    for h in result["history"]:
        log(f"epoch {h['epoch']}: train_loss {h['train_loss']:.4f} val_l1 {h['val_loss_l1']:.4f} "
            f"img/s {h['images_per_sec']:.1f} (train {h['train_seconds']:.2f}s, fds pass "
            f"{h['fds_pass_seconds']:.2f}s) calibrating {h['fds_calibrating']}")
    losses = [h["train_loss"] for h in result["history"]]
    assert all(math.isfinite(v) for v in losses), losses
    assert all(math.isfinite(v) for v in result["test"].values()), result["test"]
    for name, count in launches.items():
        assert count > 0, f"{name} was not launched on the main path"
    assert result["history"][-1]["fds_calibrating"], "the last epoch calibrated with fds_init stats"
    fds = result["final_fds"]
    assert (fds.running_var_last_epoch != 1).any() and (fds.smoothed_mean_last_epoch != 0).any()
    return launches


def profile_phase(steps: int = 5) -> None:
    """Where the time of a train step goes: ``steps`` steps of the main
    path's trainer (batch 64, 224x224, calibration on) under
    ``torch.profiler``, after three warm-up steps. Prints the step time, the
    device's busy share and the kernels that take the most device time, and
    writes the timeline to ``runs/chip_smoke/trace.json``."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from imbalanced_regression_tpu_torch.data.batching import batch_iterator
    from imbalanced_regression_tpu_torch.tasks import age
    from imbalanced_regression_tpu_torch.utils.config import parse_config

    cfg = parse_config(["--synthetic_size", "640", "--img_size", "224", "--batch_size", "64",
                        "--fds", "--lds", "--reweight", "sqrt_inv", "--save_ckpt", "0"])
    train, _, _, _ = age.build_data(cfg)
    trainer = age.build_trainer(cfg)
    state = trainer.init_state(0)
    batches = lambda k: list(batch_iterator(train, 64, rng=np.random.default_rng(k)))  # noqa: E731
    for epoch in (0, 1):  # two stats passes: a non-trivial snapshot for epoch 2
        state = trainer.fds_epoch_pass(state, batches(epoch)[:2], epoch)
    steps_in = batches(2)[: 3 + steps]
    for b in steps_in[:3]:
        trainer.train_step(state, b, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in steps_in[3:]:
            trainer.train_step(state, b, 2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device activity only (kernels and copies), grouped by name
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        # user annotations (e.g. the optimizer step's range) also appear on
        # the device timeline, spanning kernels counted on their own
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    device_ms = sum(sum(v) for v in by_name.values()) / steps
    log(f"profile: {wall_ms:.2f} ms/step on the host clock ({64e3 / wall_ms:.1f} img/s), "
        f"device busy {device_ms:.2f} ms/step ({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(len(v) for v in by_name.values()) // steps} device activities/step")
    top = sorted(by_name.items(), key=lambda kv: sum(kv[1]), reverse=True)
    for name, times in top[:15]:
        log(f"  {sum(times) / steps:8.3f} ms/step  x{len(times) // steps:<4d} {name[:100]}")
    fds_ms = sum(sum(v) for k, v in by_name.items() if "calibrate_kernel" in k or "moments_kernel" in k)
    log(f"  FDS kernels: {fds_ms / steps:.4f} ms/step")
    os.makedirs("runs/chip_smoke", exist_ok=True)
    prof.export_chrome_trace("runs/chip_smoke/trace.json")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", action="store_true",
                   help="also profile train steps of the main path (device time by kernel)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from imbalanced_regression_tpu_torch.ops import calibrate as cal
    from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
    from imbalanced_regression_tpu_torch.train import set_numerics

    set_numerics()
    t0 = time.time()
    ck.load_library()
    log(f"kernel build+load: {time.time() - t0:.1f}s -> {ck.library_path()}")
    for line in ck.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda:0")
    results = kernel_phase(ck, cal, dev)
    launches = main_path_phase(ck)
    if args.profile:
        profile_phase()

    kernels = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": r["replaces"],
                "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
               for name, r in results.items()]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
