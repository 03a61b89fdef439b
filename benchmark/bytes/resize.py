"""Bytes and operations of the depth network's bilinear resizes
(``models/depth_encdec.py`` ``_resize_bilinear``) in one train step. Each
resize of [N, C, h, w] to (H, W) is two bf16 products with float32
accumulation forward, along the width (``[W, w] @ x`` to [N, h, W, C]) and
then the height (``[H, h] @ t`` to [N, H, W, C]), and backward the two
products with the transposed weights (the weights take no gradient). A
product's least time is the larger of its bf16 operands in and its result
out at the memory rate, and two operations a multiply-add at the bf16
tensor-core peak."""

from __future__ import annotations

from dirbench.peaks import least_seconds as _least
from dirbench.spec import load_module

BF16 = 2  # bytes


def resizes(model: dict) -> list[dict]:
    """Every resize of a forward pass, ``{c, h, w, H, W}``: D's four
    up-projections (to the third, second and first stage's size and twice
    the first's), then MFF's four (each stage to twice the first's size)."""
    stages = load_module("flops", "depth").stage_shapes(model)
    c4, h4, w4 = stages[3]
    out = (2 * stages[0][1], 2 * stages[0][2])
    targets = [stages[2][1:], stages[1][1:], stages[0][1:], out]
    sources = [(c4 // 2, h4, w4)] + [(c4 // 2 ** (i + 2), *targets[i]) for i in range(3)]
    calls = [{"c": c, "h": h, "w": w, "H": hh, "W": ww}
             for (c, h, w), (hh, ww) in zip(sources, targets)]
    return calls + [{"c": c, "h": h, "w": w, "H": out[0], "W": out[1]} for c, h, w in stages]


def products(call: dict) -> list[tuple[float, float]]:
    """(bytes, bf16 operations) of the four products of one resize of
    ``call["n"]`` maps: the width and height products forward, then the
    height and width products' transposes backward."""
    n, c, h, w, hh, ww = (call[k] for k in ("n", "c", "h", "w", "H", "W"))
    x, t, y = n * h * w * c, n * h * ww * c, n * hh * ww * c  # elements in, between, out
    width = ((x + t + ww * w) * BF16, 2.0 * n * h * ww * w * c)
    height = ((t + y + hh * h) * BF16, 2.0 * n * hh * h * ww * c)
    return [width, height, height, width]


def least_seconds(call: dict) -> float:
    """The least time of one resize's four products ``{n, c, h, w, H, W}``."""
    return sum(_least(nbytes, 0.0, flops) for nbytes, flops in products(call))
