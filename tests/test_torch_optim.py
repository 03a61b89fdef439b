"""The rest of the port's Trainer held against the JAX Trainer on the CPU, from
the same converted weights, the same non-trivial FDS snapshot (calibration
on) and the same batches, with augmentation off: two SGD + momentum + L2
steps; an RRT (``retrain_fc``) step and stats pass with Adam, and with SGD
and clipping; a step with ``target_scale`` and the huber ``beta``. Also the
global-norm clip against ``optax.clip_by_global_norm`` and the loss functions
against ``TrainerConfig.loss_fn``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imbalanced_regression_tpu.data.synthetic import synthetic_age_dataset
from imbalanced_regression_tpu.fds import FDSConfig as JFDSConfig
from imbalanced_regression_tpu.models.resnet import RegressionHead as JHead
from imbalanced_regression_tpu.models.resnet import ResNetBackbone as JBackbone
from imbalanced_regression_tpu.ops.lds import prepare_weights_age
from imbalanced_regression_tpu.parallel.mesh import create_mesh
from imbalanced_regression_tpu.train import Trainer as JTrainer
from imbalanced_regression_tpu.train import TrainerConfig as JTrainerConfig
from imbalanced_regression_tpu_torch.convert import fds_state_from_numpy, from_flax
from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.models.resnet import RegressionHead, ResNetBackbone
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig, clip_by_global_norm

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
        "num_samples_tracked": rng.integers(0, 50, size=b).astype(np.float32),
    }


def _converted(jstate):
    variables = jax.tree.map(np.asarray, {"params": jstate.params["backbone"],
                                          "batch_stats": jstate.batch_stats})
    return from_flax(variables, jax.tree.map(np.asarray, jstate.params["head"]))


def _pair(rng, **cfg):
    """The JAX and the port's Trainer with ``cfg``, on the same converted
    weights and FDS snapshot, and two batches with LDS weights."""
    data = synthetic_age_dataset(n=64, img_size=16, seed=3)
    data["weight"] = prepare_weights_age(data["target"].reshape(-1), "sqrt_inv", lds=True)[:, None]
    batches = [{k: v[i * 32:(i + 1) * 32] for k, v in data.items()} for i in range(2)]
    jtrainer = JTrainer(JBackbone(stage_sizes=(1, 1), width=8, dtype=jnp.float32), JHead(),
                        JTrainerConfig(**cfg), fds_config=JFDSConfig.for_age(feature_dim=64,
                                                                               bucket_num=121),
                        mesh=create_mesh(1))
    jstate = jtrainer.init_state(jax.random.key(0), data["input"][:2])
    fds_np = _random_fds(rng, 121, 64)
    jstate = jstate.replace(fds=jstate.fds.replace(**{k: jnp.asarray(v) for k, v in fds_np.items()}))
    trainer = Trainer(ResNetBackbone(stage_sizes=(1, 1), width=8, dtype=torch.float32),
                      RegressionHead(64), TrainerConfig(**cfg),
                      fds_config=FDSConfig.for_age(feature_dim=64, bucket_num=121), device="cpu")
    state = trainer.init_state(0)
    sd = _converted(jstate)
    state.backbone.load_state_dict(sd["backbone"])
    state.head.load_state_dict(sd["head"])
    state.fds = fds_state_from_numpy(fds_np, device="cpu")
    return jtrainer, jstate, trainer, state, batches


def _weights(state):
    return {**{f"backbone.{k}": v for k, v in state.backbone.state_dict().items()},
            **{f"head.{k}": v for k, v in state.head.state_dict().items()}}


def test_sgd_steps_match_jax(rng):
    """Two SGD steps (momentum 0.9, L2 1e-2, lr 0.05) at epoch 2: the second
    step's momentum buffer holds 0.9 x the first gradient, which a missing
    or dampened momentum would change by ~50%, and the decay term is ~1% of
    the gradient, far above the rounding allowed here."""
    jtrainer, jstate, trainer, state, batches = _pair(
        rng, loss="l1", optimizer="sgd", lr=0.05, momentum=0.9, weight_decay=1e-2)
    start = {k: v.clone() for k, v in _weights(state).items()}
    for batch in batches:
        jstate, jloss, jpred = jtrainer.train_step(jstate, batch, 2)
        state, loss, pred = trainer.train_step(state, batch, 2)
        # float32 forward on both sides, reductions in another order
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want, got = _weights_of(jstate), _weights(state)
    for k, w in want.items():
        if "running" in k:
            continue
        # SGD is linear in the gradients, which agree to float32 rounding
        # (~1e-5 relative): the weights agree to 1e-4 of their total move
        moved = np.abs(w - start[k].numpy()).max()
        assert moved > 0, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * moved + 1e-7,
                                   err_msg=k)


def _weights_of(jstate):
    sd = _converted(jstate)
    return {**{f"backbone.{k}": v.numpy() for k, v in sd["backbone"].items()},
            **{f"head.{k}": v.numpy() for k, v in sd["head"].items()}}


@pytest.mark.parametrize("scale,max_norm", [(1.0, 0.5), (1.0, 50.0), (1e-4, 5e-4)],
                         ids=["clips", "keeps", "clips-small"])
def test_clip_matches_optax(rng, scale, max_norm):
    """The global norm of these gradients is ~11 x ``scale``: 0.5 clips, 50
    keeps; at a norm of ~1.1e-3, ``torch.nn.utils.clip_grad_norm_``'s
    ``norm + 1e-6`` would be ~1e-3 off, far outside the tolerance."""
    shapes = [(8, 3, 3, 3), (8,), (64, 1), (1,)]
    grads = [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm(got, max_norm)
    for g, w, orig in zip(got, want, grads):
        # the norm's float32 sum in another order: one rounding
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        assert np.array_equal(g.numpy(), orig) == (max_norm == 50.0)


@pytest.mark.parametrize("cfg", [dict(loss="l1", lr=1e-3),
                                 dict(loss="mse", optimizer="sgd", lr=0.05, momentum=0.9,
                                      weight_decay=1e-2, clip_grad_norm=0.05)],
                         ids=["adam", "sgd-clip"])
def test_retrain_fc_step_and_stats_pass_match_jax(rng, monkeypatch, cfg):
    """RRT stage 2 (``retrain_fc``): one step at epoch 2 and one stats pass.
    The head steps as the JAX masked optimizer's (with SGD the clip is over
    the head's gradients only: their norm here is ~570, so 0.05 clips, and a
    norm with the backbone's gradients in it would scale them differently);
    backbone parameters stay bit-unchanged; BN running statistics still
    update in the step and the pass, as JAX's do; calibration (K1's plain
    version) runs in the forward, its backward (K2's) never."""
    calls = {"calibrate_forward": 0, "calibrate_backward": 0}
    for name in calls:
        real = getattr(ck, name)

        def counted(*a, _name=name, _real=real):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(ck, name, counted)
    jtrainer, jstate, trainer, state, batches = _pair(rng, retrain_fc=True, **cfg)
    backbone = {k: v.clone() for k, v in state.backbone.named_parameters()}
    head = {k: v.clone() for k, v in state.head.state_dict().items()}
    buffers = {k: v.clone() for k, v in state.backbone.named_buffers()}
    assert [p for g in state.optimizer.param_groups for p in g["params"]] == list(
        state.head.parameters())

    jstate, jloss, jpred = jtrainer.train_step(jstate, batches[0], 2)
    state, loss, pred = trainer.train_step(state, batches[0], 2)
    assert calls == {"calibrate_forward": 1, "calibrate_backward": 0}
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, v in state.backbone.named_parameters():
        assert torch.equal(v, backbone[k]), k
    want = _weights_of(jstate)
    for k, v in state.head.state_dict().items():
        # Adam's first step is ~lr * sign(g) = 1e-3, SGD's lr * clipped g:
        # gradients agree to float32 rounding, the steps to 2e-5 (2% of the
        # Adam step, ~1e-4 of the SGD one)
        np.testing.assert_allclose(v.numpy(), want[f"head.{k}"], rtol=0, atol=2e-5, err_msg=k)
        assert not torch.equal(v, head[k]), k

    jstate = jtrainer.fds_epoch_pass(jstate, batches, 2)
    state = trainer.fds_epoch_pass(state, batches, 2)
    for f in FDS_FIELDS:
        # moments of encodings that differ by float32 rounding: 1e-4
        np.testing.assert_allclose(getattr(state.fds, f).numpy(), np.asarray(getattr(jstate.fds, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    want = _weights_of(jstate)
    for k, v in state.backbone.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[f"backbone.{k}"], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
            assert not torch.equal(v, buffers[k]), k


def test_target_scale_and_huber_step_match_jax(rng):
    """One Adam step with the huber loss (beta 8) on ``target / 5``: the
    errors against the scaled targets run from ~2 to ~19, so both branches
    of the loss take part, and an unscaled target or the default beta moves
    the loss far beyond the rounding allowed."""
    jtrainer, jstate, trainer, state, batches = _pair(rng, loss="huber", huber_beta=8.0,
                                                      target_scale=5.0)
    jstate, jloss, jpred = jtrainer.train_step(jstate, batches[0], 2)
    state, loss, pred = trainer.train_step(state, batches[0], 2)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want, got = _weights_of(jstate), _weights(state)
    for k, w in want.items():
        if "running" not in k:
            # Adam's first step ~1e-3: agreement to 2% of it
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("loss,beta", [("huber", 1.0), ("huber", 0.3), ("l1", 1.0),
                                       ("focal_mse", 1.0)])
def test_loss_fn_matches_jax(rng, loss, beta):
    p = rng.normal(size=(16, 1)).astype(np.float32)
    t = rng.normal(size=(16, 1)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=(16, 1)).astype(np.float32)
    got = TrainerConfig(loss=loss, huber_beta=beta).loss_fn()(
        torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(w))
    want = JTrainerConfig(loss=loss, huber_beta=beta).loss_fn()(
        jnp.asarray(p), jnp.asarray(t), jnp.asarray(w))
    # float32 elementwise, one mean: rounding only
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
