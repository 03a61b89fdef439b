"""The share of the profiled epoch in which no device activity runs: one
minus the union of the activities' intervals across streams over the
window (a sum of durations would count overlapping copies twice). Read
it beside ``profiled_epoch_stretch``: on a host-bound cell the profiler
lengthens the epoch, and most of what it adds is idle time."""


def read(obs):
    if obs.trace is None or not obs.trace.events or obs.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
