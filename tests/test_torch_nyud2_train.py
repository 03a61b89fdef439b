"""The port's Trainer on the NYUD2 path held against the JAX Trainer on the
CPU: one train step with per-pixel LDS weights (``weight_fn``), Adam with L2
(``adam_weight_decay``), the NYUD2 lr schedule and per-pixel FDS calibration
of the dense [N, H, W, C] hook, then one FDS stats pass, from the same
weights (converted from Flax), the same non-trivial FDS state and the same
batches, with augmentation off. The optimizer alone (Adam with L2) is held
against the JAX Trainer's optax chain on the same gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imbalanced_regression_tpu.data.nyud2 import make_pixel_weight_fn as j_pixel_weight_fn
from imbalanced_regression_tpu.data.nyud2 import synthetic_depth_dataset
from imbalanced_regression_tpu.fds import FDSConfig as JFDSConfig
from imbalanced_regression_tpu.models.depth_encdec import DepthEncoderDecoder as JDepth
from imbalanced_regression_tpu.models.depth_encdec import DepthHead as JDepthHead
from imbalanced_regression_tpu.ops.lds import prepare_weights_depth
from imbalanced_regression_tpu.parallel.mesh import create_mesh
from imbalanced_regression_tpu.train import Trainer as JTrainer
from imbalanced_regression_tpu.train import TrainerConfig as JTrainerConfig
from imbalanced_regression_tpu_torch.convert import depth_from_flax, fds_state_from_numpy
from imbalanced_regression_tpu_torch.data.nyud2 import TRAIN_BUCKET_NUM, make_pixel_weight_fn
from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.models.depth_encdec import DepthEncoderDecoder, DepthHead
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig

FEAT = 72  # hook width at width 8: 4 * 16 + 8 * 32 // 32
FDS_FIELDS = ("running_mean", "running_var", "running_mean_last_epoch", "running_var_last_epoch",
              "smoothed_mean_last_epoch", "smoothed_var_last_epoch", "num_samples_tracked")


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _random_fds(rng, b, d):
    """A snapshot taken after epoch 0 (state epoch 1), with real statistics,
    so calibration is not the identity."""
    return {
        "epoch": np.asarray(1, np.int32),
        "running_mean": rng.normal(size=(b, d)).astype(np.float32),
        "running_var": rng.uniform(0.2, 2.0, size=(b, d)).astype(np.float32),
        "running_mean_last_epoch": rng.normal(size=(b, d)).astype(np.float32) * 0.3,
        "running_var_last_epoch": rng.uniform(0.2, 2.0, size=(b, d)).astype(np.float32),
        "smoothed_mean_last_epoch": rng.normal(size=(b, d)).astype(np.float32) * 0.3,
        "smoothed_var_last_epoch": rng.uniform(0.2, 2.0, size=(b, d)).astype(np.float32),
        "num_samples_tracked": rng.integers(0, 5000, size=b).astype(np.float32),
    }


def _converted(jstate):
    variables = jax.tree.map(np.asarray, {"params": jstate.params["backbone"],
                                          "batch_stats": jstate.batch_stats})
    return depth_from_flax(variables, jax.tree.map(np.asarray, jstate.params["head"]))


def test_depth_train_step_and_fds_pass_match_jax(rng):
    data = synthetic_depth_dataset(8, img_hw=(64, 96), depth_hw=(32, 48), seed=3)
    batches = [{k: v[i * 4:(i + 1) * 4] for k, v in data.items()} for i in range(2)]
    weights = prepare_weights_depth(TRAIN_BUCKET_NUM, "inverse", lds=True)
    schedule = lambda epoch: 1e-3 * 0.1 ** (epoch // 5)  # noqa: E731  (tasks/nyud2.py)

    jtrainer = JTrainer(JDepth(stage_sizes=(1, 1, 1, 1), width=8, dtype=jnp.float32), JDepthHead(),
                        JTrainerConfig(loss="mse", lr=1e-3, adam_weight_decay=1e-4, schedule=()),
                        fds_config=JFDSConfig.for_depth(feature_dim=FEAT), mesh=create_mesh(1),
                        lr_schedule=schedule, weight_fn=j_pixel_weight_fn(weights))
    jstate = jtrainer.init_state(jax.random.key(0), data["input"][:2])
    fds_np = _random_fds(rng, 93, FEAT)
    jstate = jstate.replace(fds=jstate.fds.replace(**{k: jnp.asarray(v) for k, v in fds_np.items()}))

    # the same schedule as milestones every 5 epochs (tasks/nyud2.py)
    trainer = Trainer(DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8, dtype=torch.float32),
                      DepthHead(FEAT),
                      TrainerConfig(loss="mse", lr=1e-3, adam_weight_decay=1e-4, schedule=(5, 10)),
                      fds_config=FDSConfig.for_depth(feature_dim=FEAT),
                      weight_fn=make_pixel_weight_fn(weights), device="cpu")
    state = trainer.init_state(0)
    sd = _converted(jstate)
    state.backbone.load_state_dict(sd["backbone"])
    state.head.load_state_dict(sd["head"])
    state.fds = fds_state_from_numpy(fds_np, device="cpu")

    # one train step at epoch 2 (calibration on, lr 1e-3)
    jstate, jloss, jpred = jtrainer.train_step(jstate, batches[0], 2)
    state, loss, pred = trainer.train_step(state, batches[0], 2)
    assert pred.shape == (4, 32, 48, 1)
    # float32 forward on both sides, reductions in another order; train-mode
    # batch norm over as few as 24 values a channel (the 2x3 stage-4 maps of
    # 4 images) amplifies the rounding: 1e-4 of the largest prediction
    jpred = np.asarray(jpred)
    np.testing.assert_allclose(pred.numpy(), jpred, rtol=0, atol=1e-4 * np.abs(jpred).max())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    want = _converted(jstate)
    got = {**{f"backbone.{k}": v for k, v in state.backbone.state_dict().items()},
           **{f"head.{k}": v for k, v in state.head.state_dict().items()}}
    # Adam's first step moves each weight by lr * g / (|g| + eps), about
    # lr * sign(g) = 1e-3 with g = grad + wd * w; gradients agree to float32
    # rounding, so the updated weights agree to a small fraction of one step
    # (2e-5 = 2% of lr). Where g is within that rounding of 0, the two sides
    # step in opposite directions, a full 2 * lr apart: about 0.1% of these
    # weights (spread over the layers, all ~2e-3 apart), bounded at 0.5%.
    # The decay term is far below that rounding here; the next test holds it
    diffs = []
    for part in ("backbone", "head"):
        for k, v in want[part].items():
            if "running" in k:
                continue  # checked after the stats pass
            diff = np.abs(got[f"{part}.{k}"].numpy() - v.numpy())
            assert diff.max() <= 2e-3 + 2e-5, f"{part}.{k}: {diff.max()}"
            diffs.append(diff.ravel())
    diffs = np.concatenate(diffs)
    assert np.mean(diffs > 2e-5) < 5e-3, f"{int(np.sum(diffs > 2e-5))} of {diffs.size}"

    # FDS stats pass at epoch 2 over the dense hook: snapshot (state epoch
    # 1 → 2), then the update; from the JAX side's stepped weights, so the
    # sign flips above do not carry into the encodings
    state.backbone.load_state_dict(want["backbone"])
    jstate = jtrainer.fds_epoch_pass(jstate, batches, 2)
    state = trainer.fds_epoch_pass(state, batches, 2)
    assert state.fds.epoch == int(jstate.fds.epoch) == 2
    for f in FDS_FIELDS:
        # moments of 2 x 6144 pixel encodings that differ by float32
        # rounding, then variances of differences: 1e-4
        np.testing.assert_allclose(getattr(state.fds, f).numpy(), np.asarray(getattr(jstate.fds, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    want_bn = _converted(jstate)["backbone"]
    got_bn = state.backbone.state_dict()
    for k, v in want_bn.items():
        if "running" in k:
            np.testing.assert_allclose(got_bn[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def _adam_state(opt_state) -> optax.ScaleByAdamState:
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


def test_adam_weight_decay_matches_jax_optimizer():
    """Three Adam steps with L2 1e-4 on the same weights and gradients: the
    port's optimizer (``TrainerConfig.adam_weight_decay``) against the JAX
    Trainer's ``add_decayed_weights`` -> ``adam`` chain at the scheduled lr.
    The gradients are ~1e-3, so the decay term (1e-4 x weights of ~0.1) is
    ~1% of the first moment: L2 dropped, or decoupled from the moments,
    moves it far outside the float32 rounding this test allows."""
    tcfg = TrainerConfig(loss="mse", lr=1e-3, adam_weight_decay=1e-4, schedule=(5, 10))
    trainer = Trainer(DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8, dtype=torch.float32),
                      DepthHead(FEAT), tcfg, device="cpu")
    state = trainer.init_state(0)
    jtrainer = JTrainer(None, None, JTrainerConfig(loss="mse", lr=1e-3, adam_weight_decay=1e-4),
                        mesh=create_mesh(1))
    named = {f"{part}.{k}": p for part, mod in (("backbone", state.backbone), ("head", state.head))
             for k, p in mod.named_parameters()}
    # copies: on the CPU, jnp.asarray may share the buffer that torch's step
    # then updates in place
    params = {k: jnp.asarray(p.detach().numpy().copy()) for k, p in named.items()}
    opt_state = jtrainer.optimizer.init(params)
    grad_rng = np.random.default_rng(7)
    for _ in range(3):
        grads = {k: (1e-3 * grad_rng.standard_normal(p.shape)).astype(np.float32)
                 for k, p in named.items()}
        for k, p in named.items():
            p.grad = torch.from_numpy(grads[k].copy())
        state.optimizer.step()  # lr 1e-3: no milestone passed
        updates, opt_state = jtrainer.optimizer.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: u * 1e-3, updates))
    adam = _adam_state(opt_state)
    for k, p in named.items():
        moments = state.optimizer.state[p]
        # same float32 operations in another order: rounding only
        np.testing.assert_allclose(moments["exp_avg"].numpy(), np.asarray(adam.mu[k]),
                                   rtol=1e-5, atol=1e-10, err_msg=k)
        np.testing.assert_allclose(moments["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]),
                                   rtol=1e-5, atol=1e-14, err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=3e-7,
                                   atol=1e-7, err_msg=k)
