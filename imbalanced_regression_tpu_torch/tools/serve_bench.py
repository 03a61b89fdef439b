"""Serving benchmark: latency and throughput of the frozen predictor.

The counterpart of the JAX package's ``tools/serve_bench.py``. For each batch
size it exports the model (``serving.py``: one program per input shape),
loads the artifact and times the serving path as a deployment calls it:
host numpy input in, the program on the device, predictions back on the
host. One JSON line per batch size::

    {"batch": 128, "ms_per_batch": ..., "img_per_sec": ..., "p50_ms": ..., "p99_ms": ...,
     "device_ms": ..., "platform": "cuda", "input_dtype": "uint8",
     "device_name": "...", "power_limit": "..."}

``ms_per_batch`` is the mean host-clock time of one call, ``p50_ms`` and
``p99_ms`` its percentiles; ``device_ms`` is the time per call of the
program alone on input already on the card, by CUDA events over
back-to-back calls (None on the CPU, where there is no device clock);
``device_name`` and ``power_limit`` name the card (``nvidia-smi``), None on
the CPU.

Usage::

    python -m imbalanced_regression_tpu_torch.tools.serve_bench [--task age] \
        [--model resnet50] [--img_size 224] [--batches 1 8 32 128] \
        [--checkpoint <store dir>] [--device cuda|cpu]

Without ``--checkpoint`` the model serves freshly initialized weights: the
compute is the same, so the times stand; the predictions mean nothing. The
JAX tool's ``--embed_weights`` has no counterpart (``export_predictor``'s
``embed_weights`` changes nothing in a ``.pt2`` artifact).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def card_name_and_power_limit(device: torch.device) -> tuple[str | None, str | None]:
    """The card's name and power limit as ``nvidia-smi`` gives them (None,
    None on the CPU; a None power limit where ``nvidia-smi`` cannot say)."""
    if device.type != "cuda":
        return None, None
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(index)], capture_output=True, text=True, check=True)
        limit = out.stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        limit = None
    return torch.cuda.get_device_name(device), limit


def device_ms(predict, x, iters: int) -> float | None:
    """Time per call of the program on device-resident input, by CUDA events
    over ``iters`` back-to-back calls after a warm-up (None on the CPU)."""
    if predict.device.type != "cuda":
        return None
    args = predict.to_device(x)
    predict.run(args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        predict.run(args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bench_batch(predict, x, warmup: int = 3, iters: int = 20) -> dict:
    """Host-clock times of ``iters`` calls (numpy in, numpy out: the call
    returns after the predictions reached the host) after ``warmup``."""
    for _ in range(warmup):
        predict(x)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        predict(x)
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {
        "batch": int(x.shape[0]),
        "ms_per_batch": float(times.mean()) * 1e3,
        "img_per_sec": x.shape[0] / float(times.mean()),
        "p50_ms": float(np.percentile(times, 50)) * 1e3,
        "p99_ms": float(np.percentile(times, 99)) * 1e3,
        "device_ms": device_ms(predict, x, iters),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", default="age", choices=["age", "nyud2"])
    p.add_argument("--model", default="resnet50")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--batches", nargs="*", type=int, default=[1, 8, 32, 128])
    p.add_argument("--checkpoint", default="", help="store dir (optional)")
    p.add_argument("--which", default="best", choices=["best", "latest"])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="serve on the GPU (default) or, when asked, on the CPU")
    p.add_argument("--input_dtype", default=None, choices=["uint8", "float32"],
                   help="serving input dtype (default: uint8 for age, cast and normalized in "
                   "the graph; float32 for nyud2)")
    args = p.parse_args(argv)

    from imbalanced_regression_tpu_torch.serving import export_predictor, load_predictor
    from imbalanced_regression_tpu_torch.tools.export_model import (
        build_task,
        default_input_dtype,
        sample_shape,
    )

    input_dtype = np.dtype(args.input_dtype) if args.input_dtype else default_input_dtype(args.task)
    trainer, state = build_task(
        args.task,
        {"img_size": args.img_size, "model": args.model} if args.task == "age" else {},
        args.device)
    if args.checkpoint:
        from imbalanced_regression_tpu_torch.utils.checkpoint import restore_checkpoint

        state, _, _ = restore_checkpoint(args.checkpoint, state, which=args.which)

    name, power_limit = card_name_and_power_limit(trainer.device)
    rng = np.random.default_rng(0)
    results = []
    for batch in args.batches:
        shape = sample_shape(args.task, batch, args.img_size)
        if input_dtype == np.uint8:
            # raw pixel bytes, cast and normalized in the graph
            x = rng.integers(0, 256, shape, dtype=np.uint8)
        else:
            # the [0, 1] ToTensor convention
            x = rng.random(shape, dtype=np.float32)
        predict = load_predictor(
            export_predictor(trainer, state, x, platforms=(trainer.device.type,)),
            trainer.device.type)
        r = bench_batch(predict, x, iters=args.iters)
        r.update(platform=trainer.device.type, input_dtype=str(x.dtype), device_name=name,
                 power_limit=power_limit)
        results.append(r)
        print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
