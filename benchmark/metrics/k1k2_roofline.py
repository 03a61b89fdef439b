"""K1/K2 (the FDS calibrate kernels, forward and backward) against their
roofline: the least time of every call of the profiled epoch (the larger
of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s float32,
``bytes/calibrate.py``) over the device time of the ``calibrate_*``
kernels in the trace."""


def read(obs):
    if obs.trace is None:
        return None
    spent = sum(e - s for n, s, e in obs.trace.events if "calibrate_" in n)
    calls = [c for c in obs.profiled.get("kernel_calls", []) if c["kernel"] == "calibrate"]
    if spent <= 0 or not calls:
        return None
    counter = obs.counter("bytes", "calibrate")
    return 100.0 * sum(counter.least_seconds(c) for c in calls) / spent
