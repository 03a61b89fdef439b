"""The share of the profiled epoch in which no device activity runs while
the main thread is inside the program's ``step``, ``gather``, ``fds_pass``
or ``predict`` span and inside neither an ``input_wait`` nor a
``readback`` span: the device's idle time that the host's dispatch of work
leaves, as against its waits for input and its reads of results.

The program's spans are on ``time.time_ns``, the trace's clock; the trace
summary holds times from the profiled window's start, which it does not
keep. Each of the program's spans in ``PAIRS`` opens inside the
benchmark's span it is paired with (the epoch's first program span inside
the train span), within the host time of a call or two: laying the two
starts on each other places the program's spans at most that slack too
early, so the pair that places them latest is taken. Nothing where the
program records no spans."""

import threading

from dirbench import trace

DISPATCH = ("step", "gather", "fds_pass", "predict")
WAITS = ("input_wait", "readback")
# (the benchmark's span, the program's span that opens inside it; None:
# the epoch's first)
PAIRS = (("train_epoch", None), ("train_steps", None), ("fds_pass", "fds_pass"),
         ("validate", "predict"))


def intersect(a, b):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def read(obs):
    try:
        from imbalanced_regression_tpu_torch.utils.logging_tools import recorder
    except ImportError:
        return None
    summary = obs.trace
    main = threading.main_thread().ident
    spans = [s for s in recorder.closed(epochs={obs.profiled["epoch"]}) if s.thread == main]
    if summary is None or not spans or summary.window_s <= 0:
        return None
    origins = []  # the window's start on the program's clock, as each pair places it
    for bench, program in PAIRS:
        outer = summary.spans_named(bench)
        starts = [s.start_ns for s in spans if program is None or s.name == program]
        if outer and starts:
            origins.append(min(starts) - round(outer[0][1] * 1e9))
    if not origins:
        return None
    origin = min(origins)

    def union(names):
        return trace.merge(((s.start_ns - origin) * 1e-9, (s.end_ns - origin) * 1e-9)
                           for s in spans if s.name in names)

    idle_dispatch = intersect(union(DISPATCH), trace.gaps(summary.merged, summary.start,
                                                          summary.end))
    idle = length(idle_dispatch) - length(intersect(idle_dispatch, union(WAITS)))
    return 100.0 * idle / summary.window_s
