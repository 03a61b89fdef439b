"""Device time of a train step: the union of the device's activity inside
the benchmark's train-step spans of the profiled epoch, over its steps
(layer: the trainer step, ``train.py`` ``Trainer._step``)."""

TRAIN_SPANS = ("train_epoch", "train_steps")


def read(obs):
    if obs.trace is None or not obs.profiled["steps"]:
        return None
    spans = obs.trace.spans_named(*TRAIN_SPANS)
    busy = obs.trace.busy_in(spans)
    return busy * 1e3 / obs.profiled["steps"] if busy > 0 else None
