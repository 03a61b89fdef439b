"""The 95th percentile of a train step's period on the device: the time
between the completions of two consecutive steps of one epoch (on CUDA the
timing events the program records on the current stream after each
step's optimizer; on the CPU the ends of their ``step`` spans), over the
window's epochs, those other than the profiled one and the first, whose
number the set-up's checked steps share. Nothing under ``MIN_INTERVALS``
intervals, or where the program records no spans."""

import statistics

MIN_INTERVALS = 200  # at least ten intervals beyond the 95th percentile


def read(obs):
    try:
        from imbalanced_regression_tpu_torch.utils.logging_tools import recorder
    except ImportError:
        return None
    window = {e["epoch"] for e in obs.epochs[1:] if not e["profiled"]}
    periods = [s.interval_ms for s in recorder.closed("step", epochs=window)
               if s.interval_ms is not None]
    if len(periods) < MIN_INTERVALS:
        return None
    return statistics.quantiles(periods, n=20)[-1]
