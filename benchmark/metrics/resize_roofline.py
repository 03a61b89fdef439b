"""The depth decoder's resize products against their roofline: the least
time of every train step's products in the profiled epoch (counted from
the model's shapes by ``bytes/resize.py``: bf16 operands in and the result
out at 3.35 TB/s, or two operations a multiply-add at 989 TFLOP/s) over
their traced time (``resize_ms``'s kernels, which it reads only where
they pass that reader's check against the least time)."""


def read(obs):
    checked = obs.counter("metrics", "resize_ms").checked_s(obs)
    if checked is None:
        return None
    spent, least = checked
    return 100.0 * least / spent
