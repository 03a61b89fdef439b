"""The MoE layer's dispatch and combine kernels (``csrc/moe_dispatch.cu``:
the route, the gather, the combine forward and backward, the dispatch's
backward) against their roofline: the least time of every layer's calls in
the profiled epoch (``bytes/moe_dispatch.py``, from the encoder's routing
counters: each byte read or written once at 3.35 TB/s) over the traced
time of those kernels by name. Nothing where the trace holds none of them
or the epoch counts no call."""

KERNELS = ("moe_route_kernel", "moe_gather_kernel", "moe_combine_fwd_kernel",
           "moe_combine_bwd_kernel", "moe_dispatch_bwd_kernel")


def read(obs):
    if obs.trace is None:
        return None
    spent = sum(e - s for n, s, e in obs.trace.events if any(k in n for k in KERNELS))
    calls = [c for c in obs.profiled.get("kernel_calls", []) if c["kernel"] == "moe_dispatch"]
    if spent <= 0 or not calls:
        return None
    counter = obs.counter("bytes", "moe_dispatch")
    return 100.0 * sum(counter.least_seconds(c) for c in calls) / spent
