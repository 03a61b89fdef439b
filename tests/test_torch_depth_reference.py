"""The port's NYUD2 depth model and ``Trainer`` against the benchmark's
plain float32 reference (``benchmark/reference/depth.py``, which imports
nothing of the port), on one set of seeded weights drawn into both sides,
at a small size on the CPU (ResNet stages (1, 1, 1, 1) of width 8, 64x96
images, batch 4): the hook and the prediction, the per-pixel weighted
loss, every leaf's gradient, one Adam + L2 step, the stats pass's FDS
tables and a calibrated step; and the reference's LDS table against
``prepare_weights_depth``'s.

Tolerances: both sides compute in float32 (the port's model switched from
bf16 autocast to float32, as the benchmark's ``float32`` witness does), in
other orders (the resize as two matrix products against
``F.interpolate``, the loss's weights gathered in float64 against float32
tables), so values agree to float32 round-off grown through ~20 layers."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from dirbench.inputs import draw_weights  # noqa: E402
from imbalanced_regression_tpu_torch.data.nyud2 import (  # noqa: E402
    TRAIN_BUCKET_NUM,
    imagenet_normalize,
)
from imbalanced_regression_tpu_torch.ops.lds import prepare_weights_depth  # noqa: E402
from imbalanced_regression_tpu_torch.tasks import nyud2  # noqa: E402
from reference import depth as rdepth  # noqa: E402
from reference import optim as roptim  # noqa: E402
from reference import resnet as rresnet  # noqa: E402

STAGES, WIDTH, BATCH, SEED = (1, 1, 1, 1), 8, 4, 2 ** 31 + 19
IMG_HW, DEPTH_HW = (64, 96), (32, 48)
RECIPE = {"lr": 1e-4, "weight_decay": 1e-4, "reweight": "inverse", "lds": True, "lds_ks": 5,
          "lds_sigma": 2.0, "fds": True, "fds_ks": 5, "fds_sigma": 2.0, "bucket_num": 100,
          "bucket_start": 7, "start_update": 0, "start_smooth": 1, "fds_mmt": 0.9}
# float32 round-off through the network, relative to each tensor's largest
# entry; each ~5-10x the largest gap seen (maps and tables 1.6e-6-3.5e-6,
# gradients 1.0e-5-1.9e-5, the Adam step 2.9e-7), so a real difference of a
# term or a constant fails
RTOL_MAP = 2e-5
RTOL_GRAD = 1e-4  # a gradient sums ~10^4-10^5 products of round-off-sized differences
RTOL_STEP = 1e-6  # of the largest weight: a hundredth of an lr-sized move


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batches(k, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input": rng.integers(0, 256, (BATCH, *IMG_HW, 3), dtype=np.uint8),
             "target": rng.uniform(0.7, 9.99, (BATCH, *DEPTH_HW, 1)).astype(np.float32)}
            for _ in range(k)]


def _sides():
    """(trainer, state, reference model, reference FDS, LDS table), both
    sides holding the same drawn weights."""
    back0, head0 = draw_weights(list(rdepth.layout(STAGES, WIDTH)), SEED, torch.device("cpu"))
    config = nyud2.NYUDConfig(**RECIPE, device="cpu", stage_sizes=STAGES, width=WIDTH,
                              batch_size=BATCH)
    trainer = nyud2.build_nyud_trainer(config)
    state = trainer.init_state(SEED)
    for m in state.backbone.modules():  # float32, as the benchmark's witness
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32
    state.backbone.load_state_dict(back0)
    state.head.load_state_dict(head0)
    back = {k: v.clone() for k, v in back0.items()}
    head = {k: v.clone() for k, v in head0.items()}
    model = rdepth.DepthRegressor(back, head, STAGES, WIDTH)
    fds = rdepth.depth_fds(RECIPE, head["conv.weight"].shape[1], "cpu")
    table = rdepth.lds_bucket_weights("inverse", 5, 2.0, 7)
    return trainer, state, model, fds, table


def _close(got, want, rtol, what):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    scale = want.abs().max().item()
    gap = (got - want).abs().max().item()
    assert gap <= rtol * max(scale, 1e-30), f"{what}: gap {gap:.3g} at scale {scale:.3g}"


@pytest.mark.parametrize("reweight", ["inverse", "sqrt_inv"])
def test_lds_table_matches_prepare_weights_depth(reweight):
    assert rdepth.TRAIN_BUCKET_NUM == TRAIN_BUCKET_NUM
    port = prepare_weights_depth(TRAIN_BUCKET_NUM, reweight, bucket_num=100, bucket_start=7,
                                 lds=True, lds_kernel="gaussian", lds_ks=5, lds_sigma=2.0)
    ref = rdepth.lds_bucket_weights(reweight, 5, 2.0, 7)
    np.testing.assert_array_equal(port, ref.astype(np.float32))  # one formula, float64 then float32


def test_hook_prediction_and_weighted_loss():
    trainer, state, model, _, table = _sides()
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    state.backbone.train()
    hook = state.backbone(imagenet_normalize(batch["input"]))
    ref_hook = model.hook(rdepth.normalize(batch["input"]), True)
    _close(hook, ref_hook, RTOL_MAP, "hook")
    pred, ref_pred = state.head(hook), model.predict(ref_hook)
    _close(pred, ref_pred, RTOL_MAP, "prediction")
    weights = trainer.weight_fn(batch)
    ref_weights = rdepth.pixel_weights(batch["target"], table)
    torch.testing.assert_close(weights, ref_weights, rtol=0, atol=0)  # the same float32 entries
    loss = trainer._loss_fn(pred, batch["target"], weights)
    ref_loss = rdepth.weighted_mse(ref_pred, batch["target"], ref_weights)
    assert math.isclose(loss.item(), ref_loss.item(), rel_tol=RTOL_MAP)


def _ref_leaves(model):
    return {**{f"backbone.{k}": v for k, v in model.back.items() if not rresnet.is_buffer(k)},
            **{f"head.{k}": v for k, v in model.head.items()}}


def _ref_step(model, fds, table, batch, gen, epoch, adam=None):
    """The reference's step over ``batch``: (loss, raw gradients by leaf)
    and, with ``adam``, its Adam + L2 update."""
    leaves = _ref_leaves(model)
    for v in leaves.values():
        v.requires_grad_(True)
    depth = torch.from_numpy(batch["target"])
    hook = model.hook(rdepth.photometric(torch.from_numpy(batch["input"]), gen), True)
    hook = fds.smooth(rdepth.rows_of(hook), depth, epoch).view(hook.shape)
    loss = rdepth.weighted_mse(model.predict(hook), depth, rdepth.pixel_weights(depth, table))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    if adam is not None:
        adam.step(leaves, rdepth.with_l2(grads, leaves, RECIPE["weight_decay"]))
    return loss.item(), grads, leaves


def _port_leaves(state):
    return {**{f"backbone.{n}": p for n, p in state.backbone.named_parameters()},
            **{f"head.{n}": p for n, p in state.head.named_parameters()}}


def test_gradients_and_one_adam_l2_step():
    trainer, state, model, fds, table = _sides()
    batch = _batches(1, seed=1)[0]
    state, loss = trainer.train_epoch(state, iter([batch]), 0)  # no calibration before epoch 1
    gen = torch.Generator().manual_seed(SEED)  # the state's generator, as init_state seeds it
    adam = roptim.Adam(_ref_leaves(model), lr=RECIPE["lr"])
    ref_loss, grads, leaves = _ref_step(model, fds, table, batch, gen, 0, adam)
    assert math.isclose(loss, ref_loss, rel_tol=RTOL_MAP)
    port = _port_leaves(state)
    assert set(port) == set(grads)
    for name, g in grads.items():
        _close(port[name].grad, g, RTOL_GRAD, f"gradient of {name}")
    # the first Adam step moves each coordinate by lr * g / (|g| + eps'): a
    # coordinate whose two gradients differ by round-off near zero may take
    # either sign, so compare the update where |g| is above round-off
    for name, p in port.items():
        g = grads[name]
        sure = g.abs() > 1e-3 * g.abs().max()
        _close(p.detach()[sure], leaves[name].detach()[sure], RTOL_STEP, f"step of {name}")


def test_stats_pass_tables_and_a_calibrated_step():
    trainer, state, model, fds, table = _sides()
    passes = _batches(4, seed=2)
    for epoch in (0, 1):
        state = trainer.fds_epoch_pass(state, iter(passes[2 * epoch:2 * epoch + 2]), epoch)
        gen = torch.Generator().manual_seed(epoch)  # the pass's generator
        with torch.no_grad():
            feats = [rdepth.rows_of(model.hook(rdepth.photometric(
                torch.from_numpy(b["input"]), gen), True)) for b in passes[2 * epoch:2 * epoch + 2]]
        fds.update_last_epoch_stats(epoch)
        fds.update_running_stats(torch.cat(feats), torch.cat(
            [torch.from_numpy(b["target"]) for b in passes[2 * epoch:2 * epoch + 2]]), epoch)
    for name, ref in (("running_mean", fds.running_mean), ("running_var", fds.running_var),
                      ("running_mean_last_epoch", fds.mean_last),
                      ("smoothed_var_last_epoch", fds.smoothed_var)):
        _close(getattr(state.fds, name), ref, RTOL_MAP, name)
    batch = _batches(1, seed=3)[0]
    state, loss = trainer.train_epoch(state, iter([batch]), 2)  # FDS calibrates the hook
    gen = torch.Generator().manual_seed(SEED)
    ref_loss, grads, _ = _ref_step(model, fds, table, batch, gen, 2)
    assert math.isclose(loss, ref_loss, rel_tol=RTOL_MAP)
    port = _port_leaves(state)
    for name, g in grads.items():
        _close(port[name].grad, g, RTOL_GRAD, f"calibrated gradient of {name}")
