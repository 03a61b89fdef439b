"""Benchmark of the flagship age configuration's train step on one card.

The counterpart of the JAX package's ``bench.py``: ResNet-50 in bf16 with
the ``RegressionHead``, FDS calibration in every step
(``FDSConfig.for_age(feature_dim=2048, bucket_num=100, start_smooth=0)``,
so K1 runs forward and K2 backward each step), L1 with Adam at 1e-3, and
``random_crop_flip_normalize`` on the device. The input is one uint8 batch
of 128 x 224 x 224 x 3 with targets in [0, 100) and weights in [0.5, 2),
from ``np.random.default_rng(0)``, put on the card once and reused.
``--warmup`` (5) steps, then ``--steps`` (20) timed steps on the host
clock, closed by a sync; CUDA events over the same window give the device
ms per step.

Prints one JSON line::

    {"metric": "resnet50_fds_train_images_per_sec", "value": <img/s>, "unit": "img/s",
     "host_ms_per_step": ..., "device_ms_per_step": ..., "launches": {...},
     "device_name": "...", "power_limit": "...", ...}

``launches`` counts each kernel's launches over the warm-up and timed
steps (``ops/cuda_kernels.py``; on the CPU the plain versions run and none
is counted). ``device_ms_per_step``, ``device_name`` and ``power_limit``
(from ``nvidia-smi``) are None on the CPU. One card; the JAX bench's
baseline estimate has no counterpart here: it is not a number of this card.

Usage::

    python -m imbalanced_regression_tpu_torch.tools.bench [--remat conv_outs|block] \\
        [--batch 128] [--img 224] [--warmup 5] [--steps 20] [--model resnet50] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

METRIC = "resnet50_fds_train_images_per_sec"
BATCH, IMG, WARMUP, STEPS = 128, 224, 5, 20

_T0 = time.monotonic()


def hb(msg: str) -> None:
    """Progress on stderr: stdout carries only the JSON line."""
    print(f"[bench +{time.monotonic() - _T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def card_name_and_power_limit(device: torch.device) -> tuple[str | None, str | None]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card (None, None
    on the CPU or where ``nvidia-smi`` cannot say)."""
    if device.type != "cuda":
        return None, None
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(index)],
                             capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(device), None
    name, _, limit = out.rpartition(", ")
    return name, limit


def build_trainer(model: str, remat: str | None, device: str):
    from imbalanced_regression_tpu_torch.data.augment import random_crop_flip_normalize
    from imbalanced_regression_tpu_torch.fds import FDSConfig
    from imbalanced_regression_tpu_torch.models.resnet import RegressionHead
    from imbalanced_regression_tpu_torch.tasks.age import BACKBONES
    from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig

    backbone_fn, feature_dim = BACKBONES[model]
    return Trainer(
        backbone_fn(dtype=torch.bfloat16, remat=remat), RegressionHead(feature_dim),
        TrainerConfig(loss="l1", optimizer="adam", lr=1e-3),
        fds_config=FDSConfig.for_age(feature_dim=feature_dim, bucket_num=100, start_smooth=0),
        train_augment=random_crop_flip_normalize, device=device,
    )


def bench_batch(batch: int, img: int) -> dict:
    """The benchmark's batch (uint8 images, as the real input path ships
    them), from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return {
        "input": (rng.random((batch, img, img, 3)) * 255).astype(np.uint8),
        "target": rng.integers(0, 100, size=(batch, 1)).astype(np.float32),
        "weight": rng.uniform(0.5, 2.0, size=(batch, 1)).astype(np.float32),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--remat", default="", choices=["", "conv_outs", "block"],
                   help="backbone rematerialization (the JAX bench's DIR_TPU_REMAT)")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--img", type=int, default=IMG)
    p.add_argument("--warmup", type=int, default=WARMUP)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--model", default="resnet50")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default) or, when asked, on the CPU")
    args = p.parse_args(argv)

    from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck

    trainer = build_trainer(args.model, args.remat or None, args.device)
    dev = trainer.device
    hb(f"initializing {args.model} on {dev}...")
    state = trainer.init_state(0)
    # on the device once, reused by every step (train_step's copy of a
    # tensor already there is a no-op)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in bench_batch(args.batch, args.img).items()}
    before = {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}

    hb(f"warming up ({args.warmup} steps)...")
    for _ in range(args.warmup):
        state, loss, _ = trainer.train_step(state, batch, 1)
    float(loss)
    hb(f"timing {args.steps} steps...")
    timing = dev.type == "cuda"
    if timing:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss, _ = trainer.train_step(state, batch, 1)
    if timing:
        end.record()
    _sync(dev)
    dt = time.perf_counter() - t0
    loss = float(loss)

    name, power_limit = card_name_and_power_limit(dev)
    out = {
        "metric": METRIC if args.model == "resnet50" else f"{args.model}_fds_train_images_per_sec",
        "value": args.batch * args.steps / dt,
        "unit": "img/s",
        "host_ms_per_step": dt / args.steps * 1e3,
        "device_ms_per_step": start.elapsed_time(end) / args.steps if timing else None,
        "batch": args.batch, "img": args.img, "warmup": args.warmup, "steps": args.steps,
        "model": args.model, "remat": args.remat or None, "dtype": "bfloat16",
        "final_loss": loss,
        "launches": {fn.__name__: fn.launches - before[fn.__name__] for fn in ck.KERNEL_WRAPPERS},
        "platform": dev.type, "device_name": name, "power_limit": power_limit,
    }
    hb("done")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
