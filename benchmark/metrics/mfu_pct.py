"""The model operations the profiled epoch's work requires (train steps
three forward passes, stats pass and validation one; recomputation not
counted; counted from shapes by ``flops/<family>.py``) over the epoch's
length times the card's 989 TFLOP/s bf16 dense peak; read it beside
``profiled_epoch_stretch``, the profiler's lengthening of that epoch."""

from dirbench.peaks import BF16_FLOPS


def read(obs):
    flops = obs.profiled.get("model_flops")
    if obs.trace is None or not obs.trace.events or not flops or obs.trace.window_s <= 0:
        return None
    return 100.0 * flops / (obs.trace.window_s * BF16_FLOPS)
