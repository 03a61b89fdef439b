"""Which kernels the depth decoder's bilinear resizes launch on the card.

One eager train step of the NYUD2 depth model (ResNet-50, batch 32,
228x304, FDS calibrating) traced with ``torch.profiler``, with a
``record_function`` range around every ``_resize_bilinear`` call. Prints,
by kernel name and device time: the kernels launched inside those ranges
(the products forward), those launched by autograd's matrix-product
backward nodes (the transposed products; the resize weights take no
gradient, and no other product of the step has one), and those the
benchmark's ``resize_ms`` reader takes (``is_resize``) over the whole step,
with the names one side has and the other lacks. Needs a CUDA card:

    python3 resize_probe.py
"""

from __future__ import annotations

import collections
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]

from dirbench import spec  # noqa: E402
from imbalanced_regression_tpu_torch import train  # noqa: E402
from imbalanced_regression_tpu_torch.data.nyud2 import (  # noqa: E402
    DEPTH_HW,
    IMG_HW,
    synthetic_depth_dataset,
)
from imbalanced_regression_tpu_torch.models import depth_encdec  # noqa: E402
from imbalanced_regression_tpu_torch.tasks import nyud2  # noqa: E402

BATCH = 32
RANGE = "resize_bilinear"
BACKWARD = ("MmBackward", "BmmBackward")


def _wrapped(resize):
    def probe(x, size_hw):
        with torch.profiler.record_function(RANGE):
            return resize(x, size_hw)
    return probe


def _ancestors(event):
    while event is not None:
        yield event.name
        event = event.cpu_parent


def main() -> int:
    device = torch.device("cuda")
    train.graphable = lambda device, mesh: False  # eager steps: ops own their kernels
    depth_encdec._resize_bilinear = _wrapped(depth_encdec._resize_bilinear)
    config = nyud2.NYUDConfig(fds=True, lds=True, reweight="inverse", batch_size=BATCH,
                              device="cuda", save_ckpt=0)
    trainer = nyud2.build_nyud_trainer(config)
    state = trainer.init_state(0)
    data = synthetic_depth_dataset(4 * BATCH, img_hw=IMG_HW, depth_hw=DEPTH_HW)
    batches = [{k: v[i * BATCH:(i + 1) * BATCH] for k, v in data.items()} for i in range(4)]
    for epoch in (0, 1):  # statistics, so the step calibrates (K1, K2)
        state = trainer.fds_epoch_pass(state, iter(batches[:1]), epoch)
    state, _ = trainer.train_epoch(state, iter(batches[1:2]), 2)  # warm-up
    torch.cuda.synchronize()
    kinds = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=kinds) as prof:
        state, _ = trainer.train_epoch(state, iter(batches[2:3]), 2)
        torch.cuda.synchronize()
    is_resize = spec.load_module("metrics", "resize_ms").is_resize
    sides = {"forward": collections.Counter(), "backward": collections.Counter(),
             "reader": collections.Counter(), "all": collections.Counter()}
    launched = [(e, e.kernels) for e in prof.events() if getattr(e, "kernels", None)]
    if not launched:  # kernels listed as device events of their own
        launched = [(e.cpu_parent, [e]) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
    for event, kernels in launched:
        names = list(_ancestors(event))
        for k in kernels:
            us = float(getattr(k, "duration", None) or k.time_range.elapsed_us())
            sides["all"][k.name] += us
            if is_resize(k.name):
                sides["reader"][k.name] += us
            if RANGE in names:
                sides["forward"][k.name] += us
            elif any(b in n for n in names for b in BACKWARD):
                sides["backward"][k.name] += us
    products = set(sides["forward"]) | set(sides["backward"])
    out = {side: {n: round(us / 1e3, 4) for n, us in c.most_common()} for side, c in sides.items()
           if side != "all"}
    out["reader_only"] = sorted(set(sides["reader"]) - products)
    out["products_not_read"] = sorted(products - set(sides["reader"]))
    # a product's kernel that also runs outside the products: its time there
    out["also_elsewhere"] = {n: round((sides["all"][n] - sides["forward"][n]
                                       - sides["backward"][n]) / 1e3, 4) for n in products
                             if sides["all"][n] > sides["forward"][n] + sides["backward"][n] + 0.5}
    out["ms"] = {side: round(sum(c.values()) / 1e3, 3) for side, c in sides.items()}
    out["card"] = torch.cuda.get_device_name(device)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
