"""The numbers ``correct`` compares, from the program's readings and the
reference's, and the judgement against each number's limit.

A training cell compares the first steps (set-up drives them through the
window's own call): the steps' losses, the norm of the first gradient as
the optimizer got it, and the norm of the parameters' change after the
steps, leaf by leaf, as the gap between the two norms over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone under Adam and are left out of the change. Beside
those: the FDS statistics after the set-up's stats passes, and where the
cell validates, the validation predictions; where set-up also drives one
call over several batches (the ResNet cells' staging ring), that call's
mean loss and the change after it. :func:`numbers` gives every
form of each (the worst leaf or entry, the median leaf, the first step, the
norm of the difference; ``eval_bf16_units``: the validation gap over the
gap of the reference itself run in bf16, which takes out how much a seed's
weights amplify rounding); the cell's ``limits/<cell>.json`` names the
ones it compares, each with its limit (``PERF.md`` gives the readings each
limit was set from)."""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's gradient norm


@dataclasses.dataclass
class Readings:
    """What one side produced: per-step losses, per-leaf norms of the first
    gradient and of the change after the steps, FDS tables, predictions."""

    losses: list
    grad_norms: dict
    change_norms: dict
    fds_tables: dict  # name -> np.ndarray
    predictions: np.ndarray | None = None
    # the reference's: its validation predictions at the configuration's own
    # precision (bf16), the scale of what that precision moves on these inputs
    predictions_bf16: np.ndarray | None = None
    # where set-up also drives one call over several batches: its mean loss,
    # and the per-leaf norms of the change after all the steps
    epoch_loss: float | None = None
    epoch_change_norms: dict | None = None


def _leaf_gaps(prog: dict, ref: dict, leaves) -> list[float]:
    floor = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in leaves]


def _largest(prog, ref) -> float:
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(prog - ref).max() / max(np.abs(ref).max(), 1e-30))


def _relative(prog, ref) -> float:
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(prog - ref) / max(np.linalg.norm(ref), 1e-30))


def numbers(prog: Readings, ref: Readings) -> dict[str, float]:
    """Every number a cell may compare, by name; a cell's limits file says
    which it compares. ``*_gap``: the worst leaf, step or entry;
    ``*_median_gap``: the median leaf; ``*_rel_gap``: the norm of the
    difference over the reference's norm."""
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog.losses, ref.losses)]
    leaves = sorted(ref.grad_norms)
    floor = statistics.median(ref.grad_norms[k] for k in leaves)
    moving = [k for k in leaves if ref.grad_norms[k] >= NEGLIGIBLE_GRAD * floor]
    grads = _leaf_gaps(prog.grad_norms, ref.grad_norms, leaves)
    change = _leaf_gaps(prog.change_norms, ref.change_norms, moving)
    tables = sorted(ref.fds_tables)
    out = {
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "grad1_gap": max(grads),
        "grad1_median_gap": statistics.median(grads),
        "change_gap": max(change),
        "change_median_gap": statistics.median(change),
        "fds_stats_gap": max(_largest(prog.fds_tables[k], ref.fds_tables[k]) for k in tables),
        "fds_rel_gap": max(_relative(prog.fds_tables[k], ref.fds_tables[k]) for k in tables),
    }
    if ref.epoch_loss is not None:
        out["epoch_loss_gap"] = abs(prog.epoch_loss - ref.epoch_loss) / max(abs(ref.epoch_loss),
                                                                          1e-30)
        ring = _leaf_gaps(prog.epoch_change_norms, ref.epoch_change_norms, moving)
        out["epoch_change_gap"] = max(ring)
        out["epoch_change_median_gap"] = statistics.median(ring)
    if ref.predictions is not None:
        out["eval_gap"] = _largest(prog.predictions, ref.predictions)
        out["eval_rel_gap"] = _relative(prog.predictions, ref.predictions)
    if ref.predictions_bf16 is not None:
        scale = _largest(ref.predictions_bf16, ref.predictions)
        out["eval_bf16_units"] = out["eval_gap"] / max(scale, 1e-30)
    return {k: float(v) if np.isfinite(v) else float("inf") for k, v in out.items()}


def judge(values: dict[str, float], limits: dict[str, float]) -> tuple[bool, list]:
    """(every limited number within its limit, ``[name, value, limit]`` of
    each limited number). A number missing from ``values`` fails."""
    rows = [[k, values.get(k, float("inf")), limit] for k, limit in limits.items()]
    return all(v <= limit for _, v, limit in rows), rows


def details(prog: Readings, ref: Readings, top: int = 3) -> dict:
    """Where the numbers come from: the losses, and the worst leaves of the
    gradient and of the change (name, program norm, reference norm)."""
    leaves = sorted(ref.grad_norms)

    def worst(p, r):
        gaps = dict(zip(leaves, _leaf_gaps(p, r, leaves)))
        return [[k, p[k], r[k]] for k in sorted(leaves, key=gaps.get, reverse=True)[:top]]

    return {"losses": [prog.losses, ref.losses], "grad1": worst(prog.grad_norms, ref.grad_norms),
            "change": worst(prog.change_norms, ref.change_norms)}
