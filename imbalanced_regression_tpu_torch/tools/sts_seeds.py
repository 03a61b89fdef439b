"""Multi-seed STS-B-DIR comparison of the reference's arms, mean±std, on
the port's STS-B driver (``tasks/stsb.py``).

The counterpart of the JAX package's ``tools/sts_seeds.py``: the same arms
(``ARMS``, after the reference's training commands,
``sts-b-dir/README.md:59-120``), budget fields and skip key; each (arm,
seed) runs in turn in one process and appends its test metrics to
``<store_root>/sts_seed_results.jsonl``, then a mean±std table per arm and
the per-seed deltas against vanilla are printed. A pair already recorded
under the same budget is skipped, and a run in flight resumes from its own
store dir's checkpoint (``--resume`` is accepted and ignored). The ``rrt``
arm retrains the head on the same seed's vanilla ``best`` checkpoint, so
vanilla must come first in ``--arms``.

Usage::

    python -m imbalanced_regression_tpu_torch.tools.sts_seeds --data_dir <STS-B dir> \\
        --seeds 0 1 2 [--val_interval 400 --max_vals 15 --patience 10] \\
        [--store_root runs/sts_seeds] [--device cuda|cpu]

Every run is on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from imbalanced_regression_tpu_torch.tasks import stsb
from imbalanced_regression_tpu_torch.tools.aggregate_results import usable
from imbalanced_regression_tpu_torch.utils.checkpoint import has_checkpoint

# the reference's published commands (sts-b-dir/README.md:59-120): LDS with
# inverse re-weighting, FDS alone, huber with beta 0.3, the Focal-R losses,
# and RRT stage 2 with inverse re-weighting on the vanilla stage 1
ARMS = {
    "vanilla": dict(lds=False, fds=False, reweight="none"),
    "lds": dict(lds=True, fds=False, reweight="inverse", lds_sigma=2.0),
    "fds": dict(lds=False, fds=True, reweight="none", fds_sigma=2.0),
    "lds_fds": dict(lds=True, fds=True, reweight="inverse", lds_sigma=2.0,
                    fds_sigma=2.0),
    "huber": dict(lds=False, fds=False, reweight="none", loss="huber",
                  huber_beta=0.3),
    "focal_l1": dict(lds=False, fds=False, reweight="none", loss="focal_l1"),
    "focal_mse": dict(lds=False, fds=False, reweight="none", loss="focal_mse"),
    "rrt": dict(lds=False, fds=False, reweight="inverse", retrain_fc=True),
}

# the fields of the training budget: two records are comparable (and a
# recorded run skippable) only when all of them match
BUDGET_FIELDS = ("val_interval", "max_vals", "patience", "batch_size",
                 "d_hid", "n_layers_enc", "glove", "word_embs_file")


def _budget_key(arm: str, seed: int, cfg: dict) -> tuple:
    # .get: a record written before a field joined BUDGET_FIELDS has its
    # default then
    return (arm, int(seed)) + tuple(cfg.get(f) for f in BUDGET_FIELDS)


def _config(args, arm: str, seed: int) -> stsb.STSConfig:
    return stsb.STSConfig(
        dataset="stsb", data_dir=args.data_dir, glove=args.glove, seed=seed,
        store_root=args.store_root, val_interval=args.val_interval, max_vals=args.max_vals,
        patience=args.patience, batch_size=args.batch_size, d_hid=args.d_hid,
        n_layers_enc=args.n_layers_enc, word_embs_file=args.word_embs_file,
        device=args.device, **ARMS[arm],
    )


def main(argv=None) -> str:
    """Run the arms; returns the results JSONL's path."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", required=True)
    p.add_argument("--seeds", nargs="*", type=int, default=[0, 1, 2])
    p.add_argument("--arms", nargs="*", default=list(ARMS), choices=list(ARMS))
    p.add_argument("--glove", type=int, default=0)
    p.add_argument("--val_interval", type=int, default=400)
    p.add_argument("--max_vals", type=int, default=15)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--store_root", default="runs/sts_seeds")
    p.add_argument("--d_hid", type=int, default=1500)
    p.add_argument("--n_layers_enc", type=int, default=2)
    p.add_argument("--word_embs_file", default=stsb.STSConfig.word_embs_file,
                   help="embedding text file (GloVe format); with --glove 1 the table is "
                   "initialized from it and frozen (e.g. the corpus vectors of "
                   "tools/corpus_embeddings)")
    p.add_argument("--resume", default="", help="ignored (a supervisor may append it); "
                   "runs resume from their own store dirs")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default) or, when asked, on the CPU")
    args = p.parse_args(argv)

    if args.glove and not os.path.exists(args.word_embs_file):
        # --glove 1 freezes the table: without the file the runs would train
        # on frozen random embeddings
        raise SystemExit(f"--glove 1 but no embedding file at {args.word_embs_file!r} "
                         "(tools/corpus_embeddings builds one from the training corpus)")
    os.makedirs(args.store_root, exist_ok=True)
    results_path = os.path.join(args.store_root, "sts_seed_results.jsonl")
    # the skip key holds the budget: a rerun under another --max_vals,
    # --d_hid, ... runs again instead of averaging two budgets into one row
    done: set[tuple] = set()
    if os.path.exists(results_path):
        with open(results_path) as fh:
            for line in fh:
                if line.strip():
                    r = json.loads(line)
                    done.add(_budget_key(r["arm"], r["seed"], r["config"]))
    # seeds outermost (as tools/sweep): a sweep cut short has every arm at
    # the seeds it finished, so the paired deltas stand
    for seed in args.seeds:
        for arm in args.arms:
            config = _config(args, arm, seed)
            if _budget_key(arm, seed, dataclasses.asdict(config)) in done:
                print(f"=== {arm}_seed{seed} === already recorded, skipping", flush=True)
                continue
            if arm == "rrt":
                # stage 1: the same seed's vanilla run's best checkpoint
                src_dir = os.path.join(args.store_root,
                                       _config(args, "vanilla", seed).derived_store_name())
                if not has_checkpoint(src_dir, "best"):
                    raise SystemExit(
                        f"rrt arm needs the vanilla stage-1 best checkpoint at "
                        f"{src_dir}; run the vanilla arm for seed {seed} first")
                config = dataclasses.replace(config, pretrained=src_dir)
            # resume from this run's own store dir when it holds a checkpoint
            # (a fresh start when not)
            store_dir = os.path.join(args.store_root, config.derived_store_name())
            config = dataclasses.replace(config, resume=store_dir)
            name = f"{arm}_seed{seed}"
            print(f"=== {name} ===", flush=True)
            result = stsb.run(config)
            with open(results_path, "a") as fh:
                fh.write(json.dumps({
                    "name": name, "arm": arm, "seed": seed,
                    "config": dataclasses.asdict(config),
                    "test": result["test"],
                }, default=float) + "\n")
            del result
    print_summary(results_path)
    return results_path


def print_summary(results_path: str, metric: str = "mse"):
    with open(results_path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    regions = ("overall", "many", "medium", "few")
    # the last record of an (arm, seed) wins: a rerun under a corrected
    # budget supersedes the old one
    by_cell: dict[tuple, dict] = {}
    for r in records:
        by_cell[(r["arm"], r["seed"])] = r
    by_arm: dict[str, dict[str, dict[int, float]]] = {}
    for (arm, seed), r in by_cell.items():
        slot = by_arm.setdefault(arm, {reg: {} for reg in regions})
        for reg in regions:
            v = r["test"].get(reg, {}).get(metric)
            if usable(metric, v):
                slot[reg][seed] = float(v)
    print(f"\ntest {metric} (mean±std across seeds)")
    header = f"{'arm':10s}  " + "  ".join(f"{r:>14s}" for r in regions) + "   n"
    print(header)
    print("-" * len(header))
    for arm, regs in sorted(by_arm.items()):
        cells, n = [], 0
        for reg in regions:
            vals = np.asarray(list(regs[reg].values()), float)
            if len(vals) == 0:
                cells.append(f"{'—':>14s}")
                continue
            std = vals.std(ddof=1) if len(vals) > 1 else 0.0
            cells.append(f"{vals.mean():7.3f}±{std:5.3f}")
            n = max(n, len(vals))
        print(f"{arm:10s}  " + "  ".join(cells) + f"  {n:2d}")

    base = by_arm.get("vanilla")
    if not base:
        return
    print(f"\npaired per-seed deltas vs vanilla (negative = better {metric})")
    print(header.replace("  n", "  n  (t)"))
    for arm, regs in sorted(by_arm.items()):
        if arm == "vanilla":
            continue
        cells, n, tstat = [], 0, float("nan")
        for reg in regions:
            shared = sorted(set(regs[reg]) & set(base[reg]))
            if not shared:
                cells.append(f"{'—':>14s}")
                continue
            d = np.asarray([regs[reg][s] - base[reg][s] for s in shared], float)
            std = d.std(ddof=1) if len(d) > 1 else 0.0
            cells.append(f"{d.mean():+7.3f}±{std:5.3f}")
            n = max(n, len(d))
            if reg == "overall" and len(d) > 1 and std > 0:
                tstat = d.mean() / (std / np.sqrt(len(d)))
        print(f"{arm:10s}  " + "  ".join(cells) + f"  {n:2d}  (t={tstat:+.2f})")


if __name__ == "__main__":
    main(sys.argv[1:])
