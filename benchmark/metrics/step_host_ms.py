"""Host time of a train step: the median length of the program's ``step``
spans (``Trainer._step``, entry to return: the host's dispatch of the
step's work, and whatever blocks it there) over the window's epochs, those
other than the profiled one and the first, whose number the set-up's
checked steps share. Read from the program's span recorder in this
process (the newest trainer's spans); nothing where the program records
no spans."""

import statistics


def read(obs):
    try:
        from imbalanced_regression_tpu_torch.utils.logging_tools import recorder
    except ImportError:
        return None
    window = {e["epoch"] for e in obs.epochs[1:] if not e["profiled"]}
    steps = [s.ms for s in recorder.closed("step", epochs=window)]
    return statistics.median(steps) if steps else None
