"""Create the DIR balanced val/test splits of the age suites.

The counterpart of the JAX package's ``tools/make_balanced_splits.py``
(``imdb-wiki-dir/data/preprocess_imdb_wiki.py:20-44``,
``agedb-dir/data/preprocess_agedb.py``), on rows read and written by the
``csv`` module instead of pandas: for every integer age 0..120 that age's
paths are shuffled (``random.Random(666)``) and up to ``max_size`` (150 for
IMDB-WIKI, 30 for AgeDB) go to val and as many to test, so the evaluation
splits are balanced over the labels while train keeps the natural skew.

Reads ``<data_path>/meta/<db>.csv`` (``tools/create_age_meta.py``) and
writes ``<data_path>/<db>.csv`` (``age,path,split``), the meta CSV the age
driver reads.

Usage::

    python -m imbalanced_regression_tpu_torch.tools.make_balanced_splits --db imdb_wiki
    python -m imbalanced_regression_tpu_torch.tools.make_balanced_splits --db agedb
"""

from __future__ import annotations

import argparse
import collections
import csv
import os
import random

from imbalanced_regression_tpu_torch.tools.create_age_meta import write_rows


def read_rows(path: str) -> list[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def make_balanced_testset(rows: list[dict], max_size: int, seed: int = 666,
                          max_age: int = 121) -> list[dict]:
    """``rows`` (dicts with ``age`` and ``path``) with an integer ``age`` and
    a ``split`` of ``val``, ``test`` or ``train``."""
    rows = [{**r, "age": int(r["age"])} for r in rows]
    by_age = collections.defaultdict(list)  # each age's paths in row order
    for r in rows:
        by_age[r["age"]].append(r["path"])
    val_set, test_set = [], []
    rng = random.Random(seed)
    for value in range(max_age):
        paths = list(by_age[value])
        rng.shuffle(paths)
        size = min(len(paths) // 3, max_size)
        val_set += paths[:size]
        test_set += paths[size: size * 2]
    assert not set(val_set) & set(test_set)
    split = {p: "val" for p in val_set}
    split.update({p: "test" for p in test_set})
    return [{**r, "split": split.get(r["path"], "train")} for r in rows]


def main(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--db", type=str, default="imdb_wiki", choices=["imdb_wiki", "agedb"])
    parser.add_argument("--data_path", type=str, default="./data")
    parser.add_argument("--max_size", type=int, default=None,
                        help="per-age cap for val/test (default: 150 imdb_wiki, 30 agedb)")
    parser.add_argument("--seed", type=int, default=666)
    args = parser.parse_args(argv)
    max_size = args.max_size if args.max_size is not None else (150 if args.db == "imdb_wiki" else 30)

    rows = read_rows(os.path.join(args.data_path, "meta", f"{args.db}.csv"))
    out = make_balanced_testset(rows, max_size, args.seed)
    out_path = write_rows(os.path.join(args.data_path, f"{args.db}.csv"),
                          out[0].keys() if out else ("age", "path", "split"), out)
    counts = collections.Counter(r["split"] for r in out)
    print(f"Wrote {out_path}: " + ", ".join(f"{k}={v}" for k, v in counts.most_common()))
    return out_path


if __name__ == "__main__":
    main()
