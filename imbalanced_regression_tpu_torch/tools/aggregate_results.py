"""Aggregate multi-seed sweep results into mean±std tables.

A copy of the JAX package's ``tools/aggregate_results.py`` (which imports
nothing of JAX; the port keeps its own copy, held equal to it by
``tests/test_torch_tools.py``). Reads the JSONL that ``tools/sweep.py``
appends (one record per run, with a ``seed`` field and per-region shot
metrics; the port's and the JAX package's sweeps write the same schema) and
prints, per configuration (seed suffix stripped from the name), mean ±
sample std of each region's chosen metric across seeds.

Usage::

    python -m imbalanced_regression_tpu_torch.tools.aggregate_results \
        checkpoint/sweep_results.jsonl [--metric l1] [--json out.json] [--paired <config>]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict

import numpy as np

REGIONS = ("all", "many", "median", "low")


def usable(metric: str, v) -> bool:
    """Whether a recorded metric value may enter a mean/delta.

    A G-Mean of exactly 0.0 is parity-faithful to the reference's
    ``scipy.stats.gmean`` over per-sample L1 errors (imdb-wiki-dir/
    train.py:377): one exact-zero error collapses the geometric mean of the
    whole region. It is a degenerate record, not a score of 0 — averaging
    it into mean±std (or differencing it against a finite seed) poisons the
    aggregate, so it is excluded here (the per-run metric stays untouched).
    """
    if v is None or not np.isfinite(v):
        return False
    return not (metric == "gmean" and v <= 0.0)


def strip_seed(name: str) -> str:
    return re.sub(r"_seed\d+$", "", name)


def load(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def aggregate(records, metric: str = "l1"):
    """-> {config_name: {region: {mean, std, n, values}}}"""
    by_cfg: dict[str, dict[str, list[float]]] = defaultdict(lambda: defaultdict(list))
    dropped = 0
    for r in records:
        name = strip_seed(r["name"])
        shots = r.get("shots", {})
        for region in REGIONS:
            src = r.get("test", {}) if region == "all" else shots.get(region, {})
            v = src.get(metric)
            if usable(metric, v):
                by_cfg[name][region].append(float(v))
            elif v is not None and np.isfinite(v):
                dropped += 1
    if dropped:
        print(f"note: excluded {dropped} degenerate {metric}=0 record(s) "
              "from aggregation (see tools/aggregate_results.usable)",
              file=sys.stderr)
    out = {}
    for name, regions in by_cfg.items():
        out[name] = {}
        for region, vals in regions.items():
            arr = np.asarray(vals, float)
            out[name][region] = {
                "mean": float(arr.mean()),
                "std": float(arr.std(ddof=1)) if len(arr) > 1 else 0.0,
                "n": len(arr),
                "values": [round(v, 4) for v in vals],
            }
    return out


def print_table(agg, metric: str):
    width = max((len(n) for n in agg), default=10)
    header = f"{'config':{width}s}  " + "  ".join(f"{r:>14s}" for r in REGIONS) + "   n"
    print(f"metric: {metric} (mean±std across seeds)")
    print(header)
    print("-" * len(header))
    for name in sorted(agg):
        cells = []
        n = 0
        for region in REGIONS:
            s = agg[name].get(region)
            if s is None:
                cells.append(f"{'—':>14s}")
            else:
                cells.append(f"{s['mean']:7.3f}±{s['std']:5.3f}")
                n = max(n, s["n"])
        print(f"{name:{width}s}  " + "  ".join(cells) + f"  {n:2d}")


def paired_deltas(records, baseline: str, metric: str = "l1"):
    """Per-seed deltas vs the ``baseline`` config (all arms share seeds, so
    the seed-paired difference removes the dominant init/shuffle variance).
    -> {config_name: {region: {mean, std, t, n, deltas}}}"""
    by_cfg: dict[str, dict[str, dict[int, float]]] = defaultdict(lambda: defaultdict(dict))
    for r in records:
        name = strip_seed(r["name"])
        seed = r["config"]["seed"] if "config" in r else 0
        shots = r.get("shots", {})
        for region in REGIONS:
            src = r.get("test", {}) if region == "all" else shots.get(region, {})
            v = src.get(metric)
            if usable(metric, v):
                by_cfg[name][region][seed] = float(v)  # last record wins per seed
    base = by_cfg.get(baseline)
    if not base:
        raise SystemExit(f"baseline config {baseline!r} not in JSONL "
                         f"(have: {sorted(by_cfg)})")
    out = {}
    for name, regions in by_cfg.items():
        if name == baseline:
            continue
        out[name] = {}
        for region, vals in regions.items():
            shared = sorted(set(vals) & set(base.get(region, {})))
            if not shared:
                continue
            d = np.asarray([vals[s] - base[region][s] for s in shared], float)
            std = float(d.std(ddof=1)) if len(d) > 1 else 0.0
            out[name][region] = {
                "mean": float(d.mean()), "std": std, "n": len(d),
                "t": float(d.mean() / (std / np.sqrt(len(d)))) if std > 0 else float("nan"),
                "deltas": [round(v, 4) for v in d],
            }
    return out


def print_paired(paired, baseline: str, metric: str):
    width = max((len(n) for n in paired), default=10)
    header = f"{'config':{width}s}  " + "  ".join(f"{r:>18s}" for r in REGIONS) + "   n"
    print(f"\npaired per-seed deltas vs {baseline} (negative = better {metric}; t = mean/SEM)")
    print(header)
    print("-" * len(header))
    for name in sorted(paired):
        cells, n = [], 0
        for region in REGIONS:
            s = paired[name].get(region)
            if s is None:
                cells.append(f"{'—':>18s}")
            else:
                cells.append(f"{s['mean']:+7.3f} (t={s['t']:+5.2f})")
                n = max(n, s["n"])
        print(f"{name:{width}s}  " + "  ".join(cells) + f"  {n:2d}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("jsonl")
    p.add_argument("--metric", default="l1")
    p.add_argument("--json", default="", help="also dump the aggregate as JSON")
    p.add_argument("--paired", default="",
                   help="config name (seed suffix stripped) to use as the "
                        "baseline for per-seed paired deltas")
    args = p.parse_args(argv)
    records = load(args.jsonl)
    agg = aggregate(records, args.metric)
    print_table(agg, args.metric)
    if args.paired:
        print_paired(paired_deltas(records, args.paired, args.metric),
                     args.paired, args.metric)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(agg, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
