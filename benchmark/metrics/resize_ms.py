"""Device time a train step spends in the depth decoder's bilinear-resize
products (``models/depth_encdec.py`` ``_resize_bilinear``), forward and
backward: the kernels of the benchmark's train spans of the profiled epoch
that :func:`is_resize` takes, over its steps.

The products are cuBLAS kernels, but not every cuBLAS kernel of the step
is a product: cuDNN runs some of the network's convolutions through GEMM
kernels of the same families (``nvjet_*``, CUTLASS ``*gemm*``). So the
reader takes the kernels by name: those ``resize_probe.py`` found launched
inside ``_resize_bilinear`` and by its products' backward on the H100
(torch 2.11.0+cu128, batch 32 at 228x304; none of them ran anywhere else
in the step), and any kernel whose name holds ``resize``. A change of the
resize or of the toolchain may launch others: run the probe again.

The reader checks itself against the products' least time, which
``bytes/resize.py`` counts from the model's shapes: a traced time under it
means that names were missed, one over ``BAND[1]`` times it that others
were taken (the products read 2.5 times it on the H100, PERF.md). Then, or
where the profiled epoch counts no products, it reads nothing, and so does
``resize_roofline``."""

TRAIN_SPANS = ("train_epoch", "train_steps")
BAND = (1.0, 6.0)  # traced time over the products' least time
# a name matches ``k`` whole, as a template argument ``<k>`` (CUTLASS's
# ``Kernel2<k>``), or as ``void k(...)``
KERNELS = (
    "nvjet_tst_128x16_64x11_2x1_v_bz_NNT",
    "nvjet_tst_192x32_64x7_2x1_v_bz_NTT",
    "nvjet_tst_256x120_64x4_2x1_v_bz_coopA_NNT",
    "nvjet_tst_512x32_64x3_2x1_v_bz_NTT",
    "cutlass_75_tensorop_bf16_s1688gemm_bf16_128x128_nn_align1",
    "cutlass_75_tensorop_bf16_s1688gemm_bf16_256x128_nn_align1",
    "cutlass_75_tensorop_bf16_s1688gemm_bf16_256x128_nt_align1",
    "cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_nn_align1",
    "cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_nt_align1",
    "cutlass_75_wmma_tensorop_bf16_s161616gemm_bf16_32x32_32x1_nn_align1",
    "cutlass_75_wmma_tensorop_bf16_s161616gemm_bf16_32x32_32x1_nt_align1",
    "cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128_64x3_nt_align2",
    "cutlass_80_tensorop_bf16_s16816gemm_bf16_128x64_64x3_nn_align2",
    "cutlass_80_tensorop_bf16_s16816gemm_bf16_256x64_32x4_nn_align2",
    "cutlass_80_tensorop_bf16_s16816gemm_bf16_256x64_32x4_nt_align2",
    "cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_32x1_nt_align2",
    "cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_32x32_32x1_nn_align2",
    "magma_sgemmEx_kernel<float, __nv_bfloat16, __nv_bfloat16, false, true, 6, 4, 6, 3, 4>",
)


def is_resize(name: str) -> bool:
    if "resize" in name.lower():
        return True
    return any(name == k or f"<{k}>" in name or name.startswith(f"void {k}(") for k in KERNELS)


def spent_s(obs) -> float:
    """Seconds of resize products in the profiled epoch's train spans."""
    if obs.trace is None:
        return 0.0
    events = obs.trace.events_in(obs.trace.spans_named(*TRAIN_SPANS))
    return sum(e - s for n, s, e in events if is_resize(n))


def least_s(obs) -> float:
    """The least time of the profiled epoch's products (``kernel_calls``)."""
    counter = obs.counter("bytes", "resize")
    return sum(counter.least_seconds(c) for c in obs.profiled.get("kernel_calls", [])
               if c["kernel"] == "resize")


def checked_s(obs) -> tuple[float, float] | None:
    """(traced seconds, least seconds) of the products, or None where
    either is missing or their ratio lies outside ``BAND``."""
    spent, least = spent_s(obs), least_s(obs)
    if spent <= 0 or least <= 0 or not BAND[0] <= spent / least <= BAND[1]:
        return None
    return spent, least


def read(obs):
    checked = checked_s(obs)
    if checked is None or not obs.profiled.get("steps"):
        return None
    return checked[0] * 1e3 / obs.profiled["steps"]
