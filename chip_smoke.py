"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # every phase, as CI on the card runs it
    python3 chip_smoke.py --profile  # adds profiled windows of age and depth train steps

``--profile`` is a measurement tool for ``PERF.md``'s step breakdown; no
check reads it.

Phases:
1. build the CUDA kernels from ``imbalanced_regression_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card, at the
   age path's batch (N = 64 rows, D = 2048, B = 100 buckets), where K1-K3
   are timed, and at N = 128 (K3/K4 also at N = 8192); K4 is timed at N = 64
   too, for the record only (the age path does not run it);
3. the same at the NYUD2 stats-pass and train-step shape (N = 32 x 114 x
   152 = 554,496 pixels, D = 128, B = 93): K1/K2 against their plain
   versions in "positive" guard mode; K3/K4 against a float64 reference
   (exact counts, sums within 1e-5 of the bucket's sum of |f| or of f*f) and
   bit-identical across two runs; all four timed; K3 and K4 also on an
   index in runs of equal buckets along rows of 152 pixels, as a depth map
   gives;
4. drive the port's age train path (``tasks/age.py``: ResNet-50 in bf16 +
   LDS + FDS, three epochs on synthetic 224x224 images), with the kernel
   launch counters set to 0 just before and read just after;
5. the same for the NYUD2 dense-depth train path (``tasks/nyud2.py``:
   ResNet-50 encoder-decoder in bf16 + per-pixel LDS/FDS, three epochs of
   4 steps of batch 32 on synthetic 228x304 images);
6. one stats-pass batch of the trained depth model, whose encodings go
   through ``fds_bucket_moments`` with K3 and with K4 (``use_kernel="v2"``),
   held against a float64 reference and each other, and timed on them
   (with their bounds, plain versions and ``index_add_``);
7. the depth decoder's bf16 resize against float64 (output and gradient),
   and timed against ``F.interpolate``.

Phases 4-6 also check that K3 ran the kernel its plan names for the shape:
the short-batch kernel on the age path, the row split on the depth path.
``k3_probe.py`` holds the measurements behind K3's design choices.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line (one
record per kernel and shape) and as the last line ``{"ok": true, "device":
{...}}``. Exits non-zero, with no result line, when there is no CUDA device
or any phase fails.
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
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
AGE = (2048, 100)  # (D, B): ResNet-50 encoding width, age buckets
MAIN_ARGV = ["--synthetic_size", "640", "--img_size", "224", "--batch_size", "64",
             "--epoch", "3", "--fds", "--lds", "--reweight", "sqrt_inv", "--save_ckpt", "0",
             "--model", "resnet50", "--store_root", "runs/chip_smoke"]
N_MAIN = int(MAIN_ARGV[MAIN_ARGV.index("--batch_size") + 1])  # rows per kernel call on the path
# NYUD2: 160 synthetic images at the reference's 228x304 crop = 128 train
# (4 steps of 32), an FDS subset of 32 (one stats-pass batch) and 32 test
DEPTH_ARGV = ["--synthetic_size", "160", "--batch_size", "32", "--epoch", "3", "--fds", "--lds",
              "--reweight", "inverse", "--save_ckpt", "0", "--store_root", "runs/chip_smoke"]
DEPTH_BATCH = int(DEPTH_ARGV[DEPTH_ARGV.index("--batch_size") + 1])
DEPTH_HW = (114, 152)  # the hook's resolution: half the 228x304 input
N_DEPTH = DEPTH_BATCH * DEPTH_HW[0] * DEPTH_HW[1]  # rows per kernel call on the path
DEPTH = (128, 93)  # (D, B): the hook width, buckets 7..99
# the bf16 resize against float64, as a share of the largest magnitude: the
# weights, the width pass and the output each rounded to bf16 (2**-9)
RESIZE_TOL = 2.0**-6
SOURCES = {"calibrate_forward": "fds_kernels.cu", "calibrate_backward": "fds_kernels.cu",
           "segment_moments": "fds_kernels.cu", "segment_moments_v2": "moments_v2.cu"}
PALLAS = "imbalanced_regression_tpu/ops/pallas_kernels.py"
REPLACES = {"calibrate_forward": f"{PALLAS}:208", "calibrate_backward": f"{PALLAS}:236",
            "segment_moments": f"{PALLAS}:50", "segment_moments_v2": f"{PALLAS}:128"}


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


def bound(bytes_moved: float, flops: float, bf16_flops: float = 0.0) -> tuple[float, str]:
    """The least time for the work: the larger of the bytes over the memory
    rate and the operations over their unit's peak (float32 outside the
    tensor cores, bf16 on them; the two units run side by side)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS, bf16_flops / BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def calibrate_inputs(gen: torch.Generator, dev, n: int, d: int, b: int):
    """Random FDS statistics with the corner cases of the JAX tests: an
    all-zero v1 row, a zero v1 column, a negative v2, ratios beyond the
    clip range, rows with ok=False and rows with e=-1."""
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    x = r(n, d)
    e = torch.randint(0, b, (n,), generator=gen, device=dev, dtype=torch.int32)
    e[:4] = -1
    e[4:8] = 2  # rows of the all-zero v1 bucket
    ok = torch.rand(n, generator=gen, device=dev) > 0.2
    m1, m2 = r(b, d), r(b, d)
    v1, v2 = u(0.01, 3.0, b, d), u(0.01, 3.0, b, d)
    v1[2] = 0.0
    v1[5, 3] = 0.0
    v2[6, 1] = -1.0
    v2[7, :64] = 100.0
    return x, e, ok, (m1, v1, m2, v2), v1.sum(1)


def calibrate_bytes(x_elt: int, e, ok, v1sum, d: int, tables: int) -> tuple[float, int]:
    """Bytes the calibrate function must move on these inputs: x in, out,
    e and ok, and for the rows it calibrates the distinct bucket rows of
    ``tables`` [B, D] tables plus their v1sum entries. Returns (bytes,
    calibrated elements)."""
    n, b = e.numel(), v1sum.numel()
    valid = (e >= 0) & (e < b)
    on = valid & ok & (v1sum[e.clamp(min=0).long()] >= 1e-10)
    buckets = torch.unique(e[on]).numel()
    rows_on = int(on.sum())
    nbytes = n * d * x_elt + n * d * 4 + n * 4 + n + buckets * (tables * d * 4 + 4)
    return nbytes, rows_on * d


def timed(kernel, plain, library, nbytes: float, flops: float, err: float, shape: str,
          iters: int = 50, bf16_flops: float = 0.0) -> dict:
    return dict(max_abs_err=err, ms=time_ms(kernel, iters), device_ms=graph_ms(kernel),
                plain_ms=time_ms(plain, iters), library_ms=time_ms(library, iters) if library else None,
                bound=bound(nbytes, flops, bf16_flops), bytes=nbytes, shape=shape)


def shape_tag(n: int, d: int, b: int) -> str:
    return f"N={n},D={d},B={b}"


def check_calibrate(ck, cal, gen, dev, n: int, d: int, b: int, modes, record: bool,
                    iters: int = 50) -> dict:
    """K1 and K2 against their plain versions at ``n`` rows in each of
    ``modes`` ((mode, clips) pairs); with ``record``, their times and bounds
    in the first mode too."""
    results = {}
    x, e, ok, stats, v1sum = calibrate_inputs(gen, dev, n, d, b)
    # ---- K1 forward, float32 and bf16 input
    for mode, clips in modes:
        for xs in (x, x.to(torch.bfloat16)):
            args = (xs, e, ok, *stats, v1sum, *clips, mode)
            got, want = ck.calibrate_forward(*args), cal.calibrate_indexed(*args)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"K1 calibrate_forward N={n} D={d} mode={mode} x={xs.dtype}: max_abs_err {err:.3e}")
            # IEEE division/sqrt and unfused mul/add, same order: 1e-6
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    mode, clips = modes[0]
    if record:
        args = (x, e, ok, *stats, v1sum, *clips, mode)
        nbytes, elems = calibrate_bytes(4, e, ok, v1sum, d, tables=4)
        results["calibrate_forward"] = timed(
            lambda: ck.calibrate_forward(*args), lambda: cal.calibrate_indexed(*args),
            None, nbytes, 8 * elems, max_err(ck.calibrate_forward(*args), cal.calibrate_indexed(*args)),
            shape_tag(n, d, b), iters)

    # ---- K2 backward against autograd of the plain version
    g = torch.randn(n, d, generator=gen, device=dev)
    for mode_, clips_ in modes:
        xg = x.clone().requires_grad_(True)
        out = cal.calibrate_indexed(xg, e, ok, *stats, v1sum, *clips_, mode_)
        (want,) = torch.autograd.grad(out, xg, g)
        got = ck.calibrate_backward(g, e, ok, stats[1], stats[3], v1sum, *clips_, mode_)
        torch.cuda.synchronize()
        log(f"K2 calibrate_backward N={n} D={d} mode={mode_}: max_abs_err {max_err(got, want):.3e}")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if record:
        bargs = (g, e, ok, stats[1], stats[3], v1sum, *clips, mode)
        nbytes, elems = calibrate_bytes(4, e, ok, v1sum, d, tables=2)
        results["calibrate_backward"] = timed(
            lambda: ck.calibrate_backward(*bargs), lambda: cal.calibrate_indexed_grad(*bargs),
            None, nbytes, 6 * elems,
            max_err(ck.calibrate_backward(*bargs), cal.calibrate_indexed_grad(*bargs)),
            shape_tag(n, d, b), iters)
    return results


def moments_inputs(gen, dev, n: int, d: int, b: int):
    """Features with a per-column scale (as ``tests/test_pallas.py`` feeds
    the TPU kernel), every 9th row outside the buckets."""
    scale = 0.1 + 29.9 * torch.rand(1, d, generator=gen, device=dev)
    f = torch.randn(n, d, generator=gen, device=dev) * scale + 1.0
    idx = torch.randint(0, b, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx[::9] = -1
    return f, idx


def run_idx(gen, dev, n: int, b: int, width: int = DEPTH_HW[1]):
    """Bucket indices in runs along rows of ``width`` pixels, as a depth
    map's rows in NHWC order give: each row a ramp from a random bucket with
    a random slope of at most 0.2 buckets a pixel (runs of 5 or more equal
    buckets), every 97th pixel outside the buckets."""
    rows = -(-n // width)
    start = b * torch.rand(rows, 1, generator=gen, device=dev)
    slope = 0.4 * torch.rand(rows, 1, generator=gen, device=dev) - 0.2
    ramp = start + slope * torch.arange(width, device=dev)
    idx = ramp.floor().clamp(0, b - 1).to(torch.int32).reshape(-1)[:n].contiguous()
    idx[::97] = -1
    return idx


def float64_moments(f, idx, b: int):
    """counts, sums, sums of squares and sums of |f|, in float64."""
    valid = (idx >= 0) & (idx < b)
    fv, iv = f[valid].double(), idx[valid].long()
    zeros = lambda: torch.zeros((b, f.shape[1]), dtype=torch.float64, device=f.device)  # noqa: E731
    count = torch.zeros(b, dtype=torch.float64, device=f.device).index_add_(
        0, iv, torch.ones_like(iv, dtype=torch.float64))
    return (count, zeros().index_add_(0, iv, fv), zeros().index_add_(0, iv, fv * fv),
            zeros().index_add_(0, iv, fv.abs()))


def check_against_float64(name: str, got, ref) -> tuple[float, float]:
    """Counts exact; sums within 1e-5 of the bucket's sum of |f|, sums of
    squares within 1e-5 of its sum of f*f (a float32 sum of n terms is
    within about n * 2^-24 of that, and the row split keeps n to a chunk's
    rows of one bucket). Returns the worst relative errors of the two."""
    count, total, total_sq, total_abs = ref
    c, s, q = got
    assert torch.equal(c.double(), count), f"{name}: counts differ from the float64 reference"
    tiny = torch.finfo(torch.float64).tiny
    rel_s = float(((s.double() - total).abs() / total_abs.clamp(min=tiny)).max())
    rel_q = float(((q.double() - total_sq).abs() / total_sq.clamp(min=tiny)).max())
    assert rel_s <= 1e-5 and rel_q <= 1e-5, f"{name}: relative errors {rel_s:.3e}, {rel_q:.3e}"
    return rel_s, rel_q


def moments_bound(n_valid: int, n: int, d: int, b: int, v2: bool) -> tuple[float, float, float]:
    """(bytes, float32 operations, bf16 tensor-core operations) the moments
    function needs on these inputs: every index and the features of the
    rows inside the buckets in once (a row outside them adds nothing and
    need not be read), the outputs out once; 3 float32 operations per valid
    element for K3; for K4 the split (f * f and four subtractions per
    element) and the one-hot products that the data needs: each valid row's
    six bf16 terms times the one 1 of its one-hot row (a product with a 0
    adds nothing)."""
    nbytes = n_valid * d * 4 + n * 4 + b * 4 + 2 * b * d * 4
    if v2:
        return nbytes, 5 * n_valid * d, 2 * n_valid * 6 * d
    return nbytes, 3 * n_valid * d, 0.0


def library_moments(f, idx, b: int):
    """The same sums by one PyTorch call (``index_add_``, atomics) on
    prepared rows [f, f*f, 1]."""
    valid = (idx >= 0) & (idx < b)
    src = torch.cat([f[valid], f[valid] * f[valid], torch.ones_like(f[valid, :1])], 1)
    tgt = idx[valid].long()
    return lambda: torch.zeros(b, src.shape[1], device=f.device).index_add_(0, tgt, src)


def log_plan(ck, n: int, d: int) -> None:
    plan = ck.moments_plan(n, d, torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"K3 plan at N={n} D={d}: {plan}")


def check_moments(ck, gen, dev, n: int, d: int, b: int, record: bool, iters: int = 50) -> dict:
    """K3 and K4 against their plain versions at ``n`` rows, and two runs
    bit-identical; with ``record``, their times and bounds too (K4's at the
    age shape are logged only)."""
    f, idx = moments_inputs(gen, dev, n, d, b)
    log_plan(ck, n, d)
    results = {}
    for name in ("segment_moments", "segment_moments_v2"):
        kernel, plain = getattr(ck, name), getattr(ck, f"{name}_plain")
        got, again, want = kernel(f, idx, b), kernel(f, idx, b), plain(f, idx, b)
        torch.cuda.synchronize()
        errs = [max_err(a, w) for a, w in zip(got, want)]
        identical = all(torch.equal(a, w) for a, w in zip(got, again))
        log(f"{name} N={n} D={d}: count err {errs[0]:.1e}, sum err {errs[1]:.3e}, "
            f"sumsq err {errs[2]:.3e}, bit-identical across two runs: {identical}")
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)  # counts exact
        # float32 sums in another order than the one-hot matmul: 1e-5 of
        # the largest sum
        for a, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
        assert identical, f"{name} differs between two runs"
        if record:
            n_valid = int((idx >= 0).sum())
            nbytes, flops, bf16 = moments_bound(n_valid, n, d, b, name.endswith("v2"))
            library = library_moments(f, idx, b)
            torch.testing.assert_close(library()[:, :d], want[1], rtol=1e-5,
                                       atol=1e-5 * float(want[1].abs().max()))
            results[name] = timed(lambda k=kernel: k(f, idx, b), lambda p=plain: p(f, idx, b),
                                  library, nbytes, flops, max(errs), shape_tag(n, d, b), iters,
                                  bf16)
    return results


def check_depth_moments(ck, gen, dev) -> dict:
    """K3 and K4 at the NYUD2 shape against a float64 reference, bit-identical
    across two runs, and timed; on a random index and on one in runs."""
    n, (d, b) = N_DEPTH, DEPTH
    f, idx = moments_inputs(gen, dev, n, d, b)
    log_plan(ck, n, d)
    results = {}
    runs = run_idx(gen, dev, n, b)
    for name, idx_ in (("segment_moments", idx), ("segment_moments_v2", idx),
                       ("segment_moments runs", runs), ("segment_moments_v2 runs", runs)):
        kernel, plain = getattr(ck, name.split()[0]), getattr(ck, f"{name.split()[0]}_plain")
        ref = float64_moments(f, idx_, b)
        got, again = kernel(f, idx_, b), kernel(f, idx_, b)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, w) for a, w in zip(got, again))
        rel_s, rel_q = check_against_float64(name, got, ref)
        log(f"{name} N={n} D={d} B={b}: counts exact, sums within {rel_s:.3e} of sum|f|, "
            f"sumsq within {rel_q:.3e} of sum f^2 (float64 reference), bit-identical across two "
            f"runs: {identical}")
        assert identical, f"{name} differs between two runs"
        n_valid = int(((idx_ >= 0) & (idx_ < b)).sum())
        nbytes, flops, bf16 = moments_bound(n_valid, n, d, b, name.split()[0].endswith("v2"))
        err = max(max_err(a, w) for a, w in zip(got, ref[:3]))
        tag = shape_tag(n, d, b) + (",idx=runs" if name.endswith("runs") else "")
        results[name] = timed(lambda k=kernel, i=idx_: k(f, i, b),
                              lambda p=plain, i=idx_: p(f, i, b), library_moments(f, idx_, b),
                              nbytes, flops, err, tag, 10, bf16)
    return results


def log_records(results: dict) -> None:
    for name, r in results.items():
        log(f"{name} {r['shape']}: ms {r['ms']:.4f} (device {r['device_ms']:.4f}), plain_ms "
            f"{r['plain_ms']:.4f}, library_ms {r['library_ms']}, bound_ms {r['bound'][0]:.5f} "
            f"({r['bound'][1]}, {r['bytes']} bytes)")


def kernel_phase(ck, cal, dev) -> tuple[dict, dict]:
    """Every kernel against its plain version at the age path's batch
    (N_MAIN rows, where the age records are taken), at N = 128, K3/K4 at
    N = 8192; then at the NYUD2 shape. Returns the age and depth records."""
    gen = torch.Generator(device=dev).manual_seed(0)
    d, b = AGE
    age = {}
    for n in (N_MAIN, 128):
        age.update(check_calibrate(ck, cal, gen, dev, n, d, b,
                                   [("nonzero", (0.1, 10.0)), ("positive", (0.5, 2.0))],
                                   record=n == N_MAIN))
    for n in (N_MAIN, 128, 8192):
        age.update(check_moments(ck, gen, dev, n, d, b, record=n == N_MAIN))
    log_records(age)
    age.pop("segment_moments_v2")  # not on the age path: logged, not a record
    depth = check_calibrate(ck, cal, gen, dev, N_DEPTH, *DEPTH, [("positive", (0.2, 5.0))],
                            record=True, iters=10)
    depth.update(check_depth_moments(ck, gen, dev))
    log_records(depth)
    return age, depth


def main_path_phase(ck) -> dict:
    from imbalanced_regression_tpu_torch.tasks import age

    ck.reset_launch_counts()
    t0 = time.time()
    result = age.main(MAIN_ARGV)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}
    log(f"age path: {time.time() - t0:.1f}s, kernel launches {launches}")
    for h in result["history"]:
        log(f"epoch {h['epoch']}: train_loss {h['train_loss']:.4f} val_l1 {h['val_loss_l1']:.4f} "
            f"img/s {h['images_per_sec']:.1f} (train {h['train_seconds']:.2f}s, fds pass "
            f"{h['fds_pass_seconds']:.2f}s) calibrating {h['fds_calibrating']}")
    losses = [h["train_loss"] for h in result["history"]]
    assert all(math.isfinite(v) for v in losses), losses
    assert all(math.isfinite(v) for v in result["test"].values()), result["test"]
    for name in ("calibrate_forward", "calibrate_backward", "segment_moments"):
        assert launches[name] > 0, f"{name} was not launched on the age path"
    log(f"age path: K3 launches by kernel {dict(ck.segment_moments.kernels)}")
    assert ck.segment_moments.kernels == {"short": launches["segment_moments"]}
    assert result["history"][-1]["fds_calibrating"], "the last epoch calibrated with fds_init stats"
    fds = result["final_fds"]
    assert (fds.running_var_last_epoch != 1).any() and (fds.smoothed_mean_last_epoch != 0).any()
    return launches


def depth_path_phase(ck) -> tuple[dict, dict]:
    """The NYUD2 train path at full width: ResNet-50 encoder, the reference
    decoder widths, bf16, 228x304 images, batch 32."""
    from imbalanced_regression_tpu_torch.tasks import nyud2

    ck.reset_launch_counts()
    t0 = time.time()
    result = nyud2.main(DEPTH_ARGV)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}
    log(f"depth path: {time.time() - t0:.1f}s, kernel launches {launches}")
    for h in result["history"]:
        log(f"epoch {h['epoch']}: train_loss {h['train_loss']:.4f} test_rmse {h['test_rmse']:.4f} "
            f"img/s {h['images_per_sec']:.2f} (train {h['train_seconds']:.3f}s, fds pass "
            f"{h['fds_pass_seconds']:.3f}s) calibrating {h['fds_calibrating']}")
    assert all(math.isfinite(h["train_loss"]) and math.isfinite(h["test_rmse"])
               for h in result["history"]), result["history"]
    assert math.isfinite(result["best_rmse"]), result["best_rmse"]
    for name in ("calibrate_forward", "calibrate_backward", "segment_moments"):
        assert launches[name] > 0, f"{name} was not launched on the depth path"
    log(f"depth path: K3 launches by kernel {dict(ck.segment_moments.kernels)}")
    assert ck.segment_moments.kernels == {"split": launches["segment_moments"]}
    assert result["history"][-1]["fds_calibrating"], "the last epoch calibrated with fds_init stats"
    fds = result["state"].fds
    assert (fds.running_var_last_epoch != 1).any() and (fds.smoothed_mean_last_epoch != 0).any()
    return launches, result


def depth_stats_phase(ck, result) -> tuple[dict, dict]:
    """One stats-pass batch of the trained depth model (train-mode backbone,
    no_grad, the photometric augment); its encodings through
    ``fds_bucket_moments`` with K3 and with K4, held against a float64
    reference and each other, then timed on them. Returns the launches of
    this step and the two kernels' records on these encodings."""
    from imbalanced_regression_tpu_torch.data.batching import batch_iterator
    from imbalanced_regression_tpu_torch.fds import fds_bucket_moments
    from imbalanced_regression_tpu_torch.ops.binning import bin_index_depth
    from imbalanced_regression_tpu_torch.tasks import nyud2

    trainer, state = result["trainer"], result["state"]
    cfg = trainer.fds_config
    _, fds_subset, _ = nyud2.build_data(nyud2.parse_nyud_config(DEPTH_ARGV))
    batch = next(batch_iterator(fds_subset, DEPTH_BATCH, shuffle=False))
    dev = trainer.device
    with torch.no_grad():
        state.backbone.train()
        images = torch.as_tensor(batch["input"]).to(dev)
        target = torch.as_tensor(batch["target"]).to(dev)
        enc = state.backbone(trainer.train_augment(images, torch.Generator(device=dev).manual_seed(0)))
        assert enc.shape == (DEPTH_BATCH, *DEPTH_HW, DEPTH[0]) and enc.is_contiguous(), enc.shape
        ck.reset_launch_counts()
        m3 = fds_bucket_moments(cfg, enc, target)
        m4 = fds_bucket_moments(cfg, enc, target, use_kernel="v2")
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}
    log(f"depth stats-pass encodings {tuple(enc.shape)}: launches {launches}")
    assert launches["segment_moments"] == 1 and launches["segment_moments_v2"] == 1, launches
    assert ck.segment_moments.kernels == {"split": 1}, ck.segment_moments.kernels
    idx = bin_index_depth(target.reshape(-1), cfg.bucket_num, cfg.bucket_start) - cfg.bucket_start
    rows = enc.reshape(-1, cfg.feature_dim)
    ref = float64_moments(rows, idx, cfg.num_buckets)
    for name, m in (("K3", m3), ("K4", m4)):
        rel_s, rel_q = check_against_float64(name, (m.count, m.total, m.total_sq), ref)
        log(f"{name} on the stats-pass encodings: counts exact ({int(m.count.sum())} pixels in "
            f"{int((m.count > 0).sum())} buckets), sums within {rel_s:.3e} of sum|f|, sumsq within "
            f"{rel_q:.3e} of sum f^2")
    # both within 1e-5 of the float64 sums, so within 2e-5 of each other
    assert torch.equal(m3.count, m4.count)
    assert bool(((m3.total - m4.total).abs().double() <= 2e-5 * ref[3]).all())
    assert bool(((m3.total_sq - m4.total_sq).abs().double() <= 2e-5 * ref[2]).all())
    n, (d, b) = rows.shape[0], DEPTH
    assert (rows.shape[1], cfg.num_buckets) == DEPTH, (rows.shape, cfg.num_buckets)
    n_valid = int(((idx >= 0) & (idx < b)).sum())
    records = {}
    for name, m in (("segment_moments", m3), ("segment_moments_v2", m4)):
        kernel, plain = getattr(ck, name), getattr(ck, f"{name}_plain")
        nbytes, flops, bf16 = moments_bound(n_valid, n, d, b, name.endswith("v2"))
        err = max(max_err(a, w) for a, w in zip((m.count, m.total, m.total_sq), ref[:3]))
        records[f"{name} encodings"] = timed(
            lambda k=kernel: k(rows, idx, b), lambda p=plain: p(rows, idx, b),
            library_moments(rows, idx, b), nbytes, flops, err,
            shape_tag(n, d, b) + ",idx=stats-pass encodings", 10, bf16)
    log_records(records)
    return launches, records


def resize_run(resize, x, g):
    """(output, gradient in x) of ``resize`` on ``x`` with cotangent ``g``."""
    xg = x.detach().requires_grad_(True)
    y = resize(xg)
    (gx,) = torch.autograd.grad(y, xg, g)
    return y.detach(), gx


def resize_phase(dev) -> None:
    """The depth decoder's bf16 resize (``_resize_bilinear``): output and
    gradient against float64 at 8x10 -> 114x152 (the largest factor of the
    decoder), within ``RESIZE_TOL`` of the largest magnitude, with
    ``F.interpolate``'s bf16 errors logged beside; then forward + backward
    timed at ``mff_up[3]``'s shape (batch 32, 2048 channels) against
    ``F.interpolate`` in bf16 and under bf16 autocast (which runs it in
    float32)."""
    import torch.nn.functional as F

    from imbalanced_regression_tpu_torch.models.depth_encdec import _resize_bilinear

    size = DEPTH_HW
    ours = lambda a: _resize_bilinear(a, size)  # noqa: E731
    interp = lambda a: F.interpolate(a, size=size, mode="bilinear", align_corners=False)  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = lambda *s: torch.randn(*s, generator=gen, device=dev).to(  # noqa: E731
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x, g = bf16(4, 256, 8, 10), bf16(4, 256, *size)
    want = resize_run(interp, x.double(), g.double())
    errs = {}
    for name, fn in (("bilinear matmuls", ours), ("F.interpolate", interp)):
        got = resize_run(fn, x, g)
        assert all(t.dtype == torch.bfloat16 for t in got), [t.dtype for t in got]
        errs[name] = [max_err(a, w) / float(w.abs().max()) for a, w in zip(got, want)]
        log(f"bf16 resize 8x10->{size[0]}x{size[1]} by {name}: output within {errs[name][0]:.3e}, "
            f"gradient within {errs[name][1]:.3e} of the largest float64 magnitude")
    assert max(errs["bilinear matmuls"]) <= RESIZE_TOL, errs

    x, g = bf16(DEPTH_BATCH, 2048, 8, 10), bf16(DEPTH_BATCH, 2048, *size)

    def autocast_interp(a):
        with torch.autocast(device_type="cuda", dtype=torch.bfloat16):
            return interp(a)

    times = {name: time_ms(lambda fn=fn: resize_run(fn, x, g), iters=5)
             for name, fn in (("bilinear matmuls (bf16)", ours), ("F.interpolate bf16", interp),
                              ("F.interpolate under autocast (float32)", autocast_interp))}
    log(f"resize + gradient {tuple(x.shape)} -> {size}, ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))


def profile_window(name: str, trainer, state, steps_in: list, epoch: int, steps: int) -> None:
    """Where the time of a train step goes: the last ``steps`` of
    ``steps_in`` under ``torch.profiler``, after the others as warm-up.
    Prints the step time, the device's busy share and the kernels that take
    the most device time, and writes the timeline to
    ``runs/chip_smoke/trace_<name>.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    images = len(steps_in[0]["target"])
    for b in steps_in[:-steps]:
        trainer.train_step(state, b, epoch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in steps_in[-steps:]:
            trainer.train_step(state, b, epoch)
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
    log(f"profile {name}: {wall_ms:.2f} ms/step on the host clock ({images * 1e3 / wall_ms:.1f} "
        f"img/s), device busy {device_ms:.2f} ms/step ({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(len(v) for v in by_name.values()) // steps} device activities/step")
    top = sorted(by_name.items(), key=lambda kv: sum(kv[1]), reverse=True)
    for kernel, times in top[:15]:
        log(f"  {sum(times) / steps:8.3f} ms/step  x{len(times) // steps:<4d} {kernel[:100]}")
    fds_ms = sum(sum(v) for k, v in by_name.items() if "calibrate_kernel" in k or "moments_kernel" in k)
    log(f"  FDS kernels: {fds_ms / steps:.4f} ms/step")
    upsample = {k: v for k, v in by_name.items() if "upsample" in k}
    log(f"  upsample kernels: {sum(sum(v) for v in upsample.values()) / steps:.4f} ms/step "
        f"({sorted(k[:60] for k in upsample)})")
    os.makedirs("runs/chip_smoke", exist_ok=True)
    prof.export_chrome_trace(f"runs/chip_smoke/trace_{name}.json")


def profile_phase(steps: int = 5) -> None:
    """Profiled windows of ``steps`` train steps with calibration on (epoch
    2, after two stats passes), after three warm-up steps: the age path's
    trainer (batch 64, 224x224) and the depth path's (batch 32, 228x304)."""
    import numpy as np

    from imbalanced_regression_tpu_torch.data.batching import batch_iterator
    from imbalanced_regression_tpu_torch.tasks import age, nyud2
    from imbalanced_regression_tpu_torch.utils.config import parse_config

    cfg = parse_config(MAIN_ARGV)
    train, _, _, _ = age.build_data(cfg)
    trainer = age.build_trainer(cfg)
    state = trainer.init_state(0)
    batches = lambda k: list(batch_iterator(train, N_MAIN, rng=np.random.default_rng(k)))  # noqa: E731
    for epoch in (0, 1):  # two stats passes: a non-trivial snapshot for epoch 2
        state = trainer.fds_epoch_pass(state, batches(epoch)[:2], epoch)
    profile_window("age", trainer, state, batches(2)[: 3 + steps], 2, steps)

    dcfg = nyud2.parse_nyud_config(DEPTH_ARGV)
    train, fds_subset, _ = nyud2.build_data(dcfg)
    trainer = nyud2.build_nyud_trainer(dcfg)
    state = trainer.init_state(0)
    batches = lambda k: list(batch_iterator(train, DEPTH_BATCH, rng=np.random.default_rng(k)))  # noqa: E731
    for epoch in (0, 1):
        state = trainer.fds_epoch_pass(
            state, batch_iterator(fds_subset, DEPTH_BATCH, shuffle=False), epoch)
    profile_window("depth", trainer, state, (batches(2) + batches(3))[: 3 + steps], 2, steps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", action="store_true",
                   help="also profile train steps of both paths (device time by kernel)")
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
    age_records, depth_records = kernel_phase(ck, cal, dev)
    age_launches = main_path_phase(ck)
    depth_launches, depth_result = depth_path_phase(ck)
    stats_launches, stats_records = depth_stats_phase(ck, depth_result)
    depth_launches["segment_moments_v2"] = stats_launches["segment_moments_v2"]
    depth_records.update(stats_records)
    resize_phase(dev)
    if args.profile:
        profile_phase()

    kernels = []
    for records, launches in ((age_records, age_launches), (depth_records, depth_launches)):
        for key, r in records.items():
            name = key.split()[0]  # "segment_moments runs": K3 on the run-structured index
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"imbalanced_regression_tpu_torch/csrc/{SOURCES[name]}",
                "replaces": REPLACES[name], "shape": r["shape"], "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
