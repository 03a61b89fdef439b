"""Writes the committed JPEG fixture set ``tests/data/torch_age_jpegs/``.

    python tests/torch_age_jpegs.py [out_dir]

48 baseline RGB JPEGs from 150x150 to 640x480 at quality 90-95, one
grayscale and one progressive JPEG, all made from seed 0 with PIL: smooth
face-like content (a lit ellipse on a graded background, low-frequency
waves, mild noise), so the files stay small (under 1.5 MB in all) and a
resize has structure to act on. ``chip_smoke.py`` copies them into an
AgeDB-DIR-sized corpus on a machine that has no JPEG encoder; the tests
decode them with the port's and the JAX package's loaders.
"""

from __future__ import annotations

import os
import sys

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_age_jpegs")
SIZES = [(150, 150), (160, 200), (200, 200), (240, 180), (250, 250), (300, 240), (320, 240),
         (360, 300), (400, 300), (480, 360), (512, 384), (640, 480)]  # (width, height)
N_BASELINE = 48


def face_like(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    """uint8 [h, w, 3]: a graded background, a lit ellipse, soft waves, noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = xx / w - 0.5, yy / h - 0.5
    base = rng.uniform(40, 200, 3)
    tilt = rng.uniform(-60, 60, (2, 3))
    img = base + u[..., None] * tilt[0] + v[..., None] * tilt[1]
    cx, cy = rng.uniform(-0.1, 0.1, 2)
    ax, ay = rng.uniform(0.18, 0.3), rng.uniform(0.25, 0.4)
    inside = ((u - cx) / ax) ** 2 + ((v - cy) / ay) ** 2
    skin = rng.uniform(120, 230) * np.array([1.0, 0.8, 0.65])
    face = np.clip(1.2 - inside, 0, 1)[..., None]
    img = img * (1 - face) + skin * face
    freq = rng.uniform(2, 6, 2)
    img += 12 * np.sin(2 * np.pi * (freq[0] * u + freq[1] * v))[..., None]
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_fixtures(out_dir: str = OUT_DIR, seed: int = 0) -> list[str]:
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(N_BASELINE):
        w, h = SIZES[i % len(SIZES)]
        path = os.path.join(out_dir, f"img_{i:02d}.jpg")
        Image.fromarray(face_like(rng, w, h)).save(path, quality=int(rng.integers(90, 96)))
        paths.append(path)
    gray = face_like(rng, 300, 240).mean(-1).astype(np.uint8)
    paths.append(os.path.join(out_dir, "gray.jpg"))
    Image.fromarray(gray, mode="L").save(paths[-1], quality=92)
    paths.append(os.path.join(out_dir, "progressive.jpg"))
    Image.fromarray(face_like(rng, 400, 300)).save(paths[-1], quality=92, progressive=True)
    return paths


if __name__ == "__main__":
    written = write_fixtures(*sys.argv[1:2])
    total = sum(os.path.getsize(p) for p in written)
    print(f"{len(written)} files, {total} bytes")
