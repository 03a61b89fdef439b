"""K3 (the segment-moments kernel of the stats pass) against its roofline:
the least time of every call of the profiled epoch (``bytes/moments.py``)
over the device time of the ``moments_*`` and ``reduce_chunks`` kernels in
the trace."""

KERNELS = ("moments_short_kernel", "moments_split_kernel", "reduce_chunks_kernel")


def read(obs):
    if obs.trace is None:
        return None
    spent = sum(e - s for n, s, e in obs.trace.events if any(k in n for k in KERNELS))
    calls = [c for c in obs.profiled.get("kernel_calls", []) if c["kernel"] == "moments"]
    if spent <= 0 or not calls:
        return None
    counter = obs.counter("bytes", "moments")
    return 100.0 * sum(counter.least_seconds(c) for c in calls) / spent
