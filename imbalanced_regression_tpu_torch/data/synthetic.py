"""Synthetic imbalanced-regression datasets for integration tests and
benchmarks (no reference equivalent — the reference has no tests; SURVEY.md
§4 makes synthetic-data integration tests part of the rebuilt pyramid).

Images carry a label-dependent low-frequency pattern plus noise, so a
regressor can actually reduce loss in a few steps, and the label distribution
is imbalanced (Zipf-ish head + uniform tail) so LDS/FDS paths see realistic
skew."""

from __future__ import annotations

import numpy as np


def synthetic_age_dataset(
    n: int,
    img_size: int = 32,
    max_target: int = 121,
    seed: int = 0,
    dtype=np.float32,
) -> dict:
    rng = np.random.default_rng(seed)
    head = rng.normal(30.0, 6.0, size=int(n * 0.85))
    tail = rng.uniform(0, max_target - 1, size=n - len(head))
    labels = np.clip(np.round(np.concatenate([head, tail])), 0, max_target - 1).astype(dtype)
    rng.shuffle(labels)

    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(dtype) / img_size
    freq = (labels / max_target * 3.0 + 0.5)[:, None, None]  # [N,1,1]
    pattern = np.sin(freq * np.pi * (yy + xx))[..., None]  # [N,H,W,1]
    images = (pattern + 0.3 * rng.normal(size=(n, img_size, img_size, 1))).astype(dtype)
    images = np.repeat(images, 3, axis=-1)  # NHWC, 3 channels
    return {
        "input": images,
        "target": labels[:, None],
        "weight": np.ones((n, 1), dtype),
    }
