"""The profiled epoch's length over the median length of the window's
unprofiled epochs in the same run: how far the profiler's cost for each
device activity stretched the epoch that ``device_idle_pct`` and
``mfu_pct`` are read on. On a host-bound cell most of that stretch is idle
time that the unprofiled program does not have."""

import statistics


def read(obs):
    plain = [sum(e["phases"].values()) for e in obs.epochs if not e["profiled"]]
    if obs.trace is None or obs.trace.window_s <= 0 or not plain:
        return None
    return obs.trace.window_s / statistics.median(plain)
