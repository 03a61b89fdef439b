"""Generate an IMDB-WIKI-shaped JPEG corpus for full-scale rehearsals.

The counterpart of the JAX package's ``tools/make_synth_corpus.py``, with no
pandas. The real IMDB-WIKI train split is 191,509 face crops
(``imdb-wiki-dir/train.py:128-133``); this tool makes a corpus of the same
shape: N distinct file paths (hard links onto a pool of unique random
JPEGs, so generation is fast and the disk bounded while the loader still
opens and decodes N files), the source resolution, and an age distribution
with IMDB-WIKI's skew (a log-normal bulk in 20-45 with sparse tails),
written as ``<root>/<name>.csv`` (``age,path,split``), the meta CSV the age
driver reads (``--data_dir <root> --dataset <name>``).

Usage::

    python -m imbalanced_regression_tpu_torch.tools.make_synth_corpus \\
        --root /tmp/imdbwiki_synth --n 191509 --src_size 256 --protos 512
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from imbalanced_regression_tpu_torch.tools.create_age_meta import write_rows


def sample_ages(n: int, rng: np.random.Generator) -> np.ndarray:
    """Ages with IMDB-WIKI's shape: bulk 20-45, thin <10 and >80 tails."""
    bulk = rng.lognormal(mean=3.45, sigma=0.28, size=n)
    ages = np.clip(bulk.round(), 0, 120).astype(np.int64)
    # genuine few-shot extremes, so the shot bins are not empty
    k = max(n // 2000, 1)
    idx = rng.choice(n, size=2 * k, replace=False)
    ages[idx[:k]] = rng.integers(0, 8, size=k)
    ages[idx[k:]] = rng.integers(85, 116, size=k)
    return ages


def main(argv=None) -> str:
    """Write the corpus; returns the meta CSV's path."""
    from PIL import Image

    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--name", default="imdb_wiki")
    p.add_argument("--n", type=int, default=191_509)
    p.add_argument("--val", type=int, default=11_022)
    p.add_argument("--test", type=int, default=11_022)
    p.add_argument("--src_size", type=int, default=256,
                   help="prototype JPEG resolution (decode cost realism)")
    p.add_argument("--protos", type=int, default=512,
                   help="number of unique JPEGs behind the hard links")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    img_dir = os.path.join(args.root, "data")
    os.makedirs(img_dir, exist_ok=True)
    protos = []
    for j in range(args.protos):
        img = rng.integers(0, 255, (args.src_size, args.src_size, 3), dtype=np.uint8)
        path = os.path.join(img_dir, f"proto_{j}.jpg")
        Image.fromarray(img).save(path, quality=90)
        protos.append(path)

    total = args.n + args.val + args.test
    ages = sample_ages(total, rng)
    split = ["train"] * args.n + ["val"] * args.val + ["test"] * args.test
    rows = []
    for i in range(total):
        rel = f"data/{i}.jpg"
        dst = os.path.join(args.root, rel)
        if not os.path.exists(dst):
            os.link(protos[i % args.protos], dst)
        rows.append({"age": int(ages[i]), "path": rel, "split": split[i]})
    out = write_rows(os.path.join(args.root, f"{args.name}.csv"), ("age", "path", "split"), rows)
    print(f"wrote {total} files ({args.protos} unique) under {args.root}")
    return out


if __name__ == "__main__":
    main()
