"""The readings the limits of ``correct`` are set from, for one cell, on
the card at the cell's own size: the sound program over many seeds, the
control (the reference in float8 put in the program's place, one step below
the bfloat16 the configurations state) and the planted faults, each against
the float32 reference. No window is run: the numbers come from set-up.

    python3 benchmark/readings.py --workload <cell> --seeds 12 --control 3 --faults 3 \
        --fault_kinds half_batch unchanged stats_unchanged stale_slot altered_answer float32

prints one JSON line a reading (and appends them to ``--out``). The
``float32`` kind is a witness, not a fault: the program's own path with its
model in float32, which should match the reference to float32 rounding."""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR.parent), str(BENCH_DIR)]

import torch  # noqa: E402

from dirbench import compare, env, spec  # noqa: E402

FIRST_SEED = 3_000_000_000


def half_batch(trainer, state) -> None:
    """Fault: the loss of each step over half of the batch, the mean taken
    over the rest."""
    loss_fn = trainer._loss_fn

    def half(pred, target, weights):
        n = len(pred) // 2
        return loss_fn(pred[:n], target[:n], None if weights is None else weights[:n])

    trainer._loss_fn = half


def unchanged(trainer, state) -> None:
    """Fault: a step that leaves the state as it was."""
    state.optimizer.step = lambda *args, **kwargs: None


def stats_unchanged(trainer, state) -> None:
    """Fault: a stats pass that leaves the FDS state as it was."""
    trainer._fds_pass = lambda state, batches, epoch: state


def stale_slot(trainer, state) -> None:
    """Fault: the staging ring hands each step after a call's first the
    batch before its own, as a slot read before its new copy lands would."""
    device_batches = trainer._device_batches

    def stale(batches):
        previous = None
        for batch in device_batches(batches):
            yield batch if previous is None else previous
            previous = batch

    trainer._device_batches = stale


def altered_answer(trainer, state) -> None:
    """Fault: one validation prediction altered where it is produced."""
    predict_batch = trainer.predict_batch

    def altered(*args, **kwargs):
        out = predict_batch(*args, **kwargs).copy()
        out[0] += 1.0
        return out

    trainer.predict_batch = altered


def float32(trainer, state) -> None:
    """Witness, not a fault: the program's own path with its model in
    float32 (no bf16 autocast), which the reference should match to
    float32 rounding."""
    for m in state.backbone.modules():
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32


FAULTS = {"half_batch": half_batch, "unchanged": unchanged, "stats_unchanged": stats_unchanged,
          "stale_slot": stale_slot, "altered_answer": altered_answer, "float32": float32}


def workload(name: str, seed: int, device: str, overrides: dict | None = None):
    _, config, traffic = spec.cell_files(name, overrides)
    family = spec.load_module("families", config["family"])
    return family.Workload(config, traffic, seed, torch.device(device))


def reading(name: str, seed: int, kind: str, device: str = "cuda", overrides=None) -> dict:
    """The numbers of one seed: ``kind`` "sound", "control" or a fault."""
    t0 = time.time()
    work = workload(name, seed, device, overrides)
    work.make_inputs()
    if kind == "control":
        prog = work.reference(rounding="fp8")
    else:
        work.after_build = FAULTS.get(kind)
        work.setup_program()
        work.release_program()
        prog = work.program
    ref = work.reference()
    return {"cell": name, "seed": seed, "kind": kind, "numbers": compare.numbers(prog, ref),
            "detail": compare.details(prog, ref), "seconds": time.time() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--fault_kinds", nargs="*", default=["half_batch"])
    p.add_argument("--first_seed", type=int, default=FIRST_SEED)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    env.fix_cache_dirs(spec.ROOT)
    env.check_cuda(1)
    jobs = [(args.first_seed + i, "sound") for i in range(args.seeds)]
    jobs += [(args.first_seed + i, "control") for i in range(args.control)]
    jobs += [(args.first_seed + i, k) for k in args.fault_kinds for i in range(args.faults)]
    for seed, kind in jobs:
        line = json.dumps(reading(args.workload, seed, kind))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")
        torch.cuda.empty_cache()
    print(f"card: {env.card_power()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
