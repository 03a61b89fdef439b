"""The MoE layers' held-expert products (``models/deepseek_v2.py``
``grouped_mm``: one ``torch._grouped_mm`` for the gate and up projections
and one for the down projection, forward, and their two products each
backward) against their roofline: the least time of the profiled epoch's
products (``bytes/moe_dispatch.py`` ``expert_gemm``, from the encoder's
routing counters: ``6 D W`` operations a routed row forward, twice that
backward, at 989 TFLOP/s, or their bytes at 3.35 TB/s where larger) over
the traced time of the grouped-product kernels, taken by name
(:func:`is_expert_gemm`: the names ``torch._grouped_mm`` and its backward
launch on the H100, torch 2.11.0+cu128, and no other kernel of the step,
as ``tests/test_torch_moe_dispatch.py``'s card test of the reader holds).

The reader checks itself against the least time: a traced time under it
means kernels were missed, one over ``BAND[1]`` times it that others were
taken; then, or where the epoch counts no product, it reads nothing."""

BAND = (1.0, 10.0)  # traced time over the products' least time
MARKERS = ("GroupProblemShape", "grouped_gemm", "GroupedGemm")


def is_expert_gemm(name: str) -> bool:
    return any(m in name for m in MARKERS)


def read(obs):
    if obs.trace is None:
        return None
    spent = sum(e - s for n, s, e in obs.trace.events if is_expert_gemm(n))
    calls = [c for c in obs.profiled.get("kernel_calls", []) if c["kernel"] == "expert_gemm"]
    if spent <= 0 or not calls:
        return None
    counter = obs.counter("bytes", "moe_dispatch")
    least = sum(counter.least_seconds(c) for c in calls)
    if least <= 0 or not BAND[0] <= spent / least <= BAND[1]:
        return None
    return 100.0 * least / spent
