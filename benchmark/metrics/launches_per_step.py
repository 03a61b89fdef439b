"""Device activities (kernels, copies, sets) inside the benchmark's
train-step spans of the profiled epoch, over its steps (layer: host
dispatch, the eager step in ``train.py`` and ``models/``)."""

TRAIN_SPANS = ("train_epoch", "train_steps")


def read(obs):
    if obs.trace is None or not obs.profiled["steps"]:
        return None
    events = obs.trace.events_in(obs.trace.spans_named(*TRAIN_SPANS))
    return len(events) / obs.profiled["steps"] if events else None
