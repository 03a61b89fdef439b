"""Model operations of the NYUD2-DIR depth network, counted from its
shapes: two operations per multiply-add of every convolution (the ResNet
encoder, D's 1x1 convolution and up-projections, MFF, R and the final 5x5
convolution to one channel); batch norm, activations, pooling and the
bilinear resizes' products (``bytes/resize.py``) are not counted."""

from __future__ import annotations


def _out(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def stage_shapes(model: dict) -> list[tuple[int, int, int]]:
    """(channels, height, width) of each encoder stage's output at the
    model's ``img_hw``."""
    h, w = (_out(_out(s, 7, 2), 3, 2) for s in model["img_hw"])  # stem, max pool
    out = []
    for stage in range(len(model["stage_sizes"])):
        if stage > 0:
            h, w = _out(h, 3, 2), _out(w, 3, 2)
        out.append((4 * model["width"] * 2 ** stage, h, w))
    return out


def _encoder_macs(model: dict) -> int:
    width, macs = model["width"], 0
    h, w = (_out(s, 7, 2) for s in model["img_hw"])
    macs += h * w * 3 * width * 49
    h, w = _out(h, 3, 2), _out(w, 3, 2)
    cin = width
    for stage, blocks in enumerate(model["stage_sizes"]):
        mid = width * 2 ** stage
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            ho, wo = _out(h, 3, stride), _out(w, 3, stride)
            macs += h * w * cin * mid  # 1x1 at the input size
            macs += ho * wo * mid * mid * 9  # 3x3, strided
            macs += ho * wo * mid * 4 * mid  # 1x1 expansion
            if cin != 4 * mid or stride != 1:
                macs += ho * wo * cin * 4 * mid  # 1x1 strided projection
            cin, h, w = 4 * mid, ho, wo
    return macs


def _up_macs(cin: int, cout: int, pixels: int) -> int:
    """An up-projection at ``pixels`` output pixels: 5x5 and 3x3 on one
    branch, 5x5 on the other."""
    return pixels * (25 * cin * cout + 9 * cout * cout + 25 * cin * cout)


def forward_flops(model: dict) -> float:
    """Operations of one image's forward pass (``model``: ``stage_sizes``,
    ``width``, ``mff_features``, ``img_hw``)."""
    stages = stage_shapes(model)
    out = 4 * stages[0][1] * stages[0][2]  # D's output: twice the first stage's size
    c4, h4, w4 = stages[3]
    d = [c4 // 2 ** (i + 1) for i in range(5)]
    macs = _encoder_macs(model) + h4 * w4 * c4 * d[0]
    sizes = [stages[2][1] * stages[2][2], stages[1][1] * stages[1][2],
             stages[0][1] * stages[0][2], out]
    macs += sum(_up_macs(d[i], d[i + 1], sizes[i]) for i in range(4))
    mff = model["mff_features"]
    macs += sum(_up_macs(c, mff, out) for c, _, _ in stages)
    macs += out * 25 * (4 * mff) ** 2
    hook = d[4] + 4 * mff
    macs += 2 * out * 25 * hook * hook + out * 25 * hook
    return 2.0 * macs
