"""Model operations of the ResNet regression network, counted from its
shapes: two operations per multiply-add of every convolution and of the
head; batch norm, activations and pooling are not counted."""

from __future__ import annotations


def _out(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def forward_flops(model: dict, img_size: int) -> float:
    """Operations of one image's forward pass at ``img_size`` x
    ``img_size`` (``model``: ``stage_sizes``, ``width``)."""
    width, macs = model["width"], 0
    s = _out(img_size, 7, 2)
    macs += s * s * 3 * width * 49
    s = _out(s, 3, 2)  # max pool
    cin = width
    for stage, blocks in enumerate(model["stage_sizes"]):
        mid = width * 2 ** stage
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            so = _out(s, 3, stride)
            macs += s * s * cin * mid  # 1x1 at the input size
            macs += so * so * mid * mid * 9  # 3x3, strided
            macs += so * so * mid * 4 * mid  # 1x1 expansion
            if cin != 4 * mid or stride != 1:
                macs += so * so * cin * 4 * mid  # 1x1 strided projection
            cin, s = 4 * mid, so
    macs += cin  # the head
    return 2.0 * macs
