"""Ablation sweep driver: the LDS x FDS x loss x re-weighting grid plus the
RRT two-stage pipeline (the experiment matrix behind the reference's model
zoo), on the port's age driver (``tasks/age.py``).

The counterpart of the JAX package's ``tools/sweep.py``: the same grid, in
the same order, with the same store names; the same resume from
``<store_root>/sweep_results.jsonl`` (a recorded cell is skipped); the same
RRT stage 2 on top of the matching vanilla stage-1 checkpoint (``--rrt_from
vanilla``, the reference's recipe, ``imdb-wiki-dir/README.md:86``,
``train.py:154-155``) or of the cell's own (``--rrt_from self``), rerun when
the recorded stage 2 used the other pairing. Its records have the JAX
schema (``name``, ``seed``, ``config``, ``test``, ``shots``, and
``rrt_from`` on stage-2 records), so either package's
``tools/aggregate_results.py`` reads either file.

Usage::

    python -m imbalanced_regression_tpu_torch.tools.sweep --dataset agedb --data_dir ./data \\
        --losses l1 focal_l1 --reweights none sqrt_inv --epoch 90 [--rrt] [--seeds 0 1 2]
    python -m imbalanced_regression_tpu_torch.tools.sweep --synthetic_size 512 --epoch 2

Every cell runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys

from imbalanced_regression_tpu_torch.tasks import age
from imbalanced_regression_tpu_torch.utils.checkpoint import has_checkpoint
from imbalanced_regression_tpu_torch.utils.config import ExperimentConfig, defaults_for_dataset


def grid(args) -> list[ExperimentConfig]:
    configs = []
    # seeds outermost: a sweep cut short leaves every cell with the same
    # number of seeds. Within each (seed, loss) group the plain cells
    # (reweight 'none', LDS/FDS off) run first: RRT stage 2 under
    # --rrt_from vanilla pairs every reweighted cell with the vanilla cell
    # of its (loss, seed), whose checkpoint must then exist, whatever the
    # order of the options given
    reweights = sorted(args.reweights, key=lambda r: r != "none")
    lds_options = sorted(args.lds_options)
    fds_options = sorted(args.fds_options)
    for seed, loss, reweight, lds, fds in itertools.product(
        args.seeds, args.losses, reweights, lds_options, fds_options
    ):
        if lds and reweight == "none":
            continue  # LDS requires re-weighting (datasets.py:57)
        # the dataset's profile (agedb: lds_ks 9, bucket_start 3, ...), then
        # the sweep's explicit overrides on top
        base = defaults_for_dataset(args.dataset)
        overrides = {
            k: v for k, v in (
                ("lds_ks", args.lds_ks), ("lds_sigma", args.lds_sigma),
                ("fds_ks", args.fds_ks), ("fds_sigma", args.fds_sigma),
            ) if v is not None
        }
        configs.append(dataclasses.replace(
            base,
            data_dir=args.data_dir, store_root=args.store_root,
            loss=loss, reweight=reweight, lds=lds, fds=fds, seed=seed,
            epoch=args.epoch, batch_size=args.batch_size, lr=args.lr,
            synthetic_size=args.synthetic_size, img_size=args.img_size, device=args.device,
            # only the cells that can be an RRT stage-1 source write
            # checkpoints (the vanilla cells under --rrt_from vanilla, every
            # stage-1 cell under self); the rest keep their best state in
            # memory
            save_ckpt=1 if args.rrt and (
                args.rrt_from == "self"
                or (reweight == "none" and not lds and not fds)
            ) else 0,
            **overrides,
        ))
    return configs


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--dataset", type=str, default="imdb_wiki")
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--store_root", type=str, default="checkpoint")
    parser.add_argument("--losses", nargs="*", default=["l1", "focal_l1"])
    parser.add_argument("--reweights", nargs="*", default=["none", "sqrt_inv"])
    parser.add_argument("--lds_options", nargs="*", type=int, default=[0, 1])
    parser.add_argument("--fds_options", nargs="*", type=int, default=[0, 1])
    parser.add_argument("--lds_ks", type=int, default=None,
                        help="override the dataset profile's LDS kernel size")
    parser.add_argument("--lds_sigma", type=float, default=None)
    parser.add_argument("--fds_ks", type=int, default=None)
    parser.add_argument("--fds_sigma", type=float, default=None)
    parser.add_argument("--epoch", type=int, default=90)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--img_size", type=int, default=224)
    parser.add_argument("--synthetic_size", type=int, default=0)
    parser.add_argument("--rrt", action="store_true", help="run RRT stage 2 on each run")
    parser.add_argument("--rrt_from", choices=["vanilla", "self"], default="vanilla",
                        help="stage-1 checkpoint for RRT: 'vanilla' pairs each "
                             "reweighted cell with the plain (reweight=none, no "
                             "LDS/FDS) cell of the same loss+seed (the reference "
                             "recipe, imdb-wiki-dir/train.py:154-155); 'self' "
                             "retrains on the cell's own checkpoint")
    parser.add_argument("--seeds", nargs="*", type=int, default=[0],
                        help="run every grid cell once per seed; aggregate "
                             "with tools/aggregate_results.py")
    parser.add_argument("--resume", default="", help="ignored (a supervisor may append "
                        "it on restart); recorded cells are skipped through the results JSONL")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="run the cells on the GPU (default) or, when asked, on the CPU")
    return parser.parse_args(argv)


def _append(path: str, record: dict) -> None:
    with open(path, "a") as fh:
        fh.write(json.dumps(record, default=float) + "\n")


def main(argv=None) -> str:
    """Run the grid; returns the results JSONL's path."""
    args = parse_args(argv)
    results_path = os.path.join(args.store_root, "sweep_results.jsonl")
    os.makedirs(args.store_root, exist_ok=True)
    done: dict[str, dict] = {}
    if os.path.exists(results_path):  # resume an interrupted sweep
        with open(results_path) as fh:
            done = {r["name"]: r for r in map(json.loads, filter(str.strip, fh))}
    for config in grid(args):
        name = config.derived_store_name()
        if name in done:
            print(f"=== {name} === (already recorded, skipping)", flush=True)
        else:
            print(f"=== {name} ===", flush=True)
            result = age.run(config)
            record = {"name": name, "seed": config.seed, "config": dataclasses.asdict(config),
                      "test": result["test"], "shots": result["shots"]}
            del result  # the trainer and its state
            _append(results_path, record)
            done[name] = record

        # stage 2 resumes on its own: a restart after the stage-1 record
        # landed still runs (does not skip) the stage-2 retrain
        if args.rrt and config.reweight != "none":
            src_name = name
            if args.rrt_from == "vanilla":
                src_name = dataclasses.replace(
                    config, reweight="none", lds=False, fds=False,
                ).derived_store_name()
            src_path = os.path.join(args.store_root, src_name)
            stage2 = dataclasses.replace(config, retrain_fc=True, pretrained=src_path)
            name2 = stage2.derived_store_name()
            if name2 in done:
                # the store name does not encode --rrt_from: a sweep resumed
                # under the other mode reruns stage 2 on the source it asks for
                recorded_src = done[name2].get("rrt_from", src_name)
                if recorded_src == src_name:
                    print(f"=== {name2} === (already recorded, skipping)", flush=True)
                    continue
                print(f"=== {name2} === recorded with stage-1 {recorded_src}, "
                      f"current --rrt_from wants {src_name}; rerunning "
                      "(appends a second record; aggregate the intended one)", flush=True)
            if not has_checkpoint(src_path, "best"):
                raise SystemExit(
                    f"RRT stage 2 needs the stage-1 checkpoint at {src_path}; "
                    "with --rrt_from vanilla, include 'none' in --reweights and "
                    "0 in --lds_options/--fds_options so the vanilla cell runs "
                    "first (or pass --rrt_from self)")
            print(f"=== RRT stage 2 on {src_name} ===", flush=True)
            result2 = age.run(stage2)
            _append(results_path, {
                "name": name2, "rrt_from": src_name, "seed": config.seed,
                "config": dataclasses.asdict(stage2),
                "test": result2["test"], "shots": result2["shots"],
            })
            del result2
            done[name2] = {"name": name2, "rrt_from": src_name}
    print(f"Results: {results_path}", flush=True)
    return results_path


if __name__ == "__main__":
    main(sys.argv[1:])
