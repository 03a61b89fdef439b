"""One run of one cell: set-up, the timed window of whole epochs, the
per-layer readings, the comparison with the reference, the result line.

The window starts at the first timed instruction after set-up and ends at
the first epoch boundary after ``--seconds``, closed by a device
synchronization, so every epoch in it carries its stats pass (and its
validation, where the cell validates). ``--trace 1`` adds one profiled
epoch after the window's last and reports the cell's per-layer metrics
instead of its end-to-end ones: last, because the profiler leaves the
epochs after it slower on a host-bound cell, and the unprofiled epochs
before it are the ones the host-clock readers read."""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from dirbench import compare, env, spec, trace

WINDOW_SPAN = "profiled_epoch"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Observation:
    """What the per-layer readers read: the window's epochs (host clock),
    the profiled epoch's record (its kernel calls and model operations) and
    its trace."""

    def __init__(self, epochs, profiled, summary):
        self.epochs, self.profiled, self.trace = epochs, profiled, summary

    def counter(self, kind: str, name: str):
        return spec.load_module(kind, name)


def read_per_layer(metrics: list[dict], obs: Observation) -> dict:
    out = {}
    for m in metrics:
        value = spec.load_module("metrics", m["name"]).read(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
             overrides: dict | None = None, prepare=None):
    """Run cell ``name``; returns (result, compared rows). ``overrides``
    deep-merges into the configuration and traffic (small sizes for tests);
    ``prepare(workload)`` runs before set-up (planted faults in tests)."""
    import torch

    t_start = env.process_start_time()
    bench = spec.load_spec()
    cell, config, traffic = spec.cell_files(name, overrides)
    limits = spec.load_json("limits", name)
    dev = torch.device(device)
    if dev.type == "cuda":
        env.check_cuda(cell["chips"])
        torch.cuda.reset_peak_memory_stats(dev)
    work = spec.load_module("families", config["family"]).Workload(config, traffic, seed, dev)
    if prepare is not None:
        prepare(work)
    t_inputs = time.time()
    work.make_inputs()
    t_program = time.time()
    work.setup_program()
    setup_s = time.time() - t_start
    _log(f"set-up: {t_inputs - t_start:.3f} s to the inputs (imports, CUDA), inputs "
         f"{t_program - t_inputs:.3f} s, program {time.time() - t_program:.3f} s")

    spans, epochs, summary = trace.Spans(), [], None
    epoch = work.first_epoch
    t0 = time.perf_counter()
    while True:
        epochs.append(work.run_epoch(epoch, spans, False))
        epoch += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if traced:
        prof = trace.profiler(dev)
        prof.start()
        with spans.span(WINDOW_SPAN):
            epochs.append(work.run_epoch(epoch, spans, True))
        prof.stop()
        window = spans.records[-1]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    samples = sum(e["samples"] for e in epochs)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result, extra = {"correct": False, "attempted": samples, "failed": 0}, {}
    if traced:
        summary = trace.summarize(prof, window, spans.records)
        prof = None
        obs = Observation(epochs, next(e for e in epochs if e["profiled"]), summary)
        result["metrics"] = read_per_layer(spec.metrics_of_cell(bench, name, "per_layer"), obs)
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        extra["breakdown"] = trace.breakdown(summary)
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        result["metrics"] = {
            "train_samples_per_s": {"value": samples / window_s,  # no profiled epoch here
                                    "unit": units["train_samples_per_s"]},
            "setup_s": {"value": setup_s, "unit": units["setup_s"]}}
    result["device"] = device_info
    result.update(extra)
    _log(f"cell {name} seed {seed}: {len(epochs)} epochs, {samples} samples in {window_s:.3f} s, "
         f"set-up {setup_s:.3f} s, device peak {peak} bytes; epochs (s): "
         + " ".join(f"{sum(e['phases'].values()):.3f}" for e in epochs))

    work.release_program()
    values = compare.numbers(work.program, work.reference())
    correct, rows = compare.judge(values, limits)
    result["correct"] = correct
    result["failed"] = 0 if correct else samples
    result["checked"] = [[k, v if math.isfinite(v) else str(v), lim] for k, v, lim in rows]
    return result, rows


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    env.fix_cache_dirs(spec.ROOT)
    try:
        result, rows = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except env.NoDevice as exc:
        _log(f"no run: {exc}")
        return 3
    forbidden = env.forbidden_loaded()
    if forbidden:
        _log(f"no result: modules loaded that no run may load: {', '.join(forbidden)}")
        return 4
    if args.trace:
        _log(f"card: {env.card_power()}")
    for k, v, limit in rows:
        _log(f"check {k} = {v!r} (limit {limit!r})")
    print(json.dumps(result), flush=True)
    return 0
