"""Bytes of the MoE layer's dispatch and combine (``csrc/moe_dispatch.cu``)
and operations of its held experts' products, for one layer over the
calls of one phase of the profiled epoch, from the encoder's routing
counters: ``{calls, tokens, rows, touched, d, k, held, width, elt,
backward}``, where ``tokens`` counts every token position of the phase's
calls (padding included: the layer routes them all), ``rows`` the held
slots routed, ``touched`` the tokens with at least one, ``elt`` the bytes
of the module type (bf16).

Each input byte is counted read once and each output byte written once:

- route: the router's choices in (int64 [T, K]), each slot's row out (int32)
  and the offsets;
- gather: the touched tokens' rows in, the routed rows out;
- combine: the routed rows of the products and each slot's row and weight
  in, the float32 [T, D] sum out;
- backward (steps only): the combine's float32 [T, D] gradient, the routed
  rows and the slots in, the rows' gradient and the weights' out; the
  dispatch's: the rows' gradient and the slots in, [T, D] out.

The expert products (``expert_gemm``): ``6 D W`` operations a routed row
forward (gate and up ``2 D 2W``, down ``2 W D``), twice that backward; the
experts' bf16 weights in and the rows in and out once a product."""

from __future__ import annotations

from dirbench.peaks import least_seconds as _least


def dispatch_bytes(c: dict) -> float:
    t, rows, touched, d, k, e = (c[n] for n in ("tokens", "rows", "touched", "d", "k", "elt"))
    slots = t * k
    route = slots * 8 + slots * 4 + c["calls"] * c["held"] * 4
    gather = (touched + rows) * d * e + slots * 4
    combine = rows * d * e + slots * 8 + t * d * 4
    total = route + gather + combine
    if c["backward"]:
        total += t * d * 4 + 2 * rows * d * e + slots * 12  # combine's backward
        total += rows * d * e + slots * 4 + t * d * e  # dispatch's backward
    return float(total)


def expert_work(c: dict) -> tuple[float, float]:
    """(bytes, bf16 operations) of the held experts' products."""
    d, w, e, rows = c["d"], c["width"], c["elt"], c["rows"]
    passes = 3 if c["backward"] else 1
    weights = c["held"] * 3 * d * w * e * passes * c["calls"]
    rows_io = rows * (d + 2 * w + w + d) * e * passes
    return float(weights + rows_io), 6.0 * d * w * rows * passes


def least_seconds(call: dict) -> float:
    """The least time of one call record: ``kernel`` "moe_dispatch" (bytes
    at 3.35 TB/s) or "expert_gemm" (the larger of its bytes and its
    operations at 989 TFLOP/s)."""
    if call["kernel"] == "expert_gemm":
        nbytes, flops = expert_work(call)
        return _least(nbytes, 0.0, flops)
    return _least(dispatch_bytes(call), 0.0)
