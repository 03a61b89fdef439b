"""Where a cell's files are: everything is found by the names in
``BENCHMARK.json``, so a new cell, configuration, traffic mix, family,
counter or per-layer metric is a new file and no edit.

- ``configs/<config>.json``: the configuration (its ``family`` names the
  workload module);
- ``traffic/<traffic>.json``: the traffic mix;
- ``limits/<cell>.json``: the limits of the numbers ``correct`` compares;
- ``families/<family>.py``: the workload that drives the program;
- ``flops/<family>.py``, ``bytes/<kernel>.py``: the counters;
- ``metrics/<metric>.py``: the reader of one per-layer metric."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
KINDS = ("configs", "traffic", "limits", "families", "flops", "bytes", "metrics")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as fh:
        return json.load(fh)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def path_of(kind: str, name: str) -> Path:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    suffix = ".py" if kind in ("families", "flops", "bytes", "metrics") else ".json"
    return BENCH_DIR / kind / f"{name}{suffix}"


def load_json(kind: str, name: str) -> dict:
    with open(path_of(kind, name), encoding="utf-8") as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py``, loaded by its path (a name may hold
    dots and dashes) and kept in ``sys.modules`` under a private name."""
    key = f"dirbench_{kind}_" + re.sub(r"\W", "_", name)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path_of(kind, name))
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def metrics_of_cell(spec: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
    without a ``workloads`` list, and those whose list names it."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def merged(base, part):
    """``part`` deep-merged over ``base`` (dicts by key, anything else
    replaced)."""
    if isinstance(base, dict) and isinstance(part, dict):
        return {**base, **{k: merged(base.get(k), v) for k, v in part.items()}}
    return part


def cell_files(name: str, overrides: dict | None = None):
    """(cell, configuration, traffic) of cell ``name``, with ``overrides``
    merged over the configuration's and the traffic's keys."""
    cell = find_cell(load_spec(), name)
    config, traffic = load_json("configs", cell["config"]), load_json("traffic", cell["traffic"])
    for key, part in (overrides or {}).items():
        target = config if key in config else traffic
        target[key] = merged(target.get(key), part)
    return cell, config, traffic
