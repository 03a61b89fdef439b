"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), as ``chip_smoke.py`` states them
(its ``HBM_BYTES_PER_S``, ``FP32_FLOPS``, ``BF16_FLOPS``)."""

HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth
FP32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_FLOPS = 989e12  # bf16 on the tensor cores, dense


def least_seconds(nbytes: float, flops: float, bf16_flops: float = 0.0) -> float:
    """The least time the work can take: the larger of its bytes over the
    memory rate and its operations over their unit's peak (float32 outside
    the tensor cores and bf16 on them run side by side)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS, bf16_flops / BF16_FLOPS)
