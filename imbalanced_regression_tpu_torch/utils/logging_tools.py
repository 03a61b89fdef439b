"""Observability: scalar metrics writer (JSONL) and host
memory readings.

The reference logs scalars to TensorBoard per epoch
(``imdb-wiki-dir/train.py:219-222``, ``nyud2-dir/train.py:209``) and measures
only wall-clock meters (SURVEY.md §5.1). The rebuild adds:

- a :class:`MetricsWriter` that mirrors every scalar to a ``metrics.jsonl``
  file (machine-readable run history);
- :func:`host_memory_gb` — current and peak RSS of the process.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    """Append-only scalar logger writing one JSON object per line to
    ``metrics.jsonl`` (machine-readable run history). With ``enabled``
    false (the ranks of a data-parallel run other than 0) it writes
    nothing."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self._jsonl = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step), "time": time.time()}
        ) + "\n")

    def log_dict(self, scalars: dict, step: int, prefix: str = "") -> None:
        for key, value in scalars.items():
            if isinstance(value, (int, float)):
                self.log_scalar(f"{prefix}{key}", value, step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()


def host_memory_gb() -> tuple[float, float]:
    """(current RSS, peak RSS) of this process in GB (Linux ``/proc``).

    Production observability for the bounded-memory input modes
    (``data/streaming.py``): the stream/mmap paths promise host RSS stays at
    a few batches; the epoch log records whether that holds at 191k-image
    scale. Returns (0, 0) where /proc is unavailable."""
    cur = peak = 0.0
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    cur = int(line.split()[1]) / 1e6  # kB -> GB
                elif line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) / 1e6
    except OSError:
        pass
    return cur, peak
