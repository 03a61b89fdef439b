"""The port's Trainer on the STS-B path held against the JAX Trainer on the
CPU, from the same converted weights and FDS statistics: three indexed
steps (dropout 0, clipping at 5.0, targets / 5, MSE, LDS weights, FDS in
the ``hist`` grouping from ``start_smooth`` 0, so K1 and K2's plain
versions calibrate every step) give the same losses and predictions
within 1e-5 relative, and the indexed FDS stats pass the same state
within 1e-5; on the port's side, ``train_step_indexed`` equals
``train_step`` on the gathered batch bit for bit, dropout included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_stsb_tiny import pair_input

from imbalanced_regression_tpu.data.batching import index_iterator as j_index_iterator
from imbalanced_regression_tpu.fds import FDSConfig as JFDSConfig
from imbalanced_regression_tpu.models.bilstm_pair import PairBiLSTMEncoder as JEncoder
from imbalanced_regression_tpu.models.resnet import RegressionHead as JHead
from imbalanced_regression_tpu.parallel.mesh import create_mesh
from imbalanced_regression_tpu.train import Trainer as JTrainer
from imbalanced_regression_tpu.train import TrainerConfig as JTrainerConfig
from imbalanced_regression_tpu_torch.convert import fds_state_from_numpy, stsb_from_flax
from imbalanced_regression_tpu_torch.data.batching import eval_batches, index_iterator, tree_map
from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.models.bilstm_pair import PairBiLSTMEncoder
from imbalanced_regression_tpu_torch.models.resnet import RegressionHead
from imbalanced_regression_tpu_torch.ops.binning import bin_index_hist_np
from imbalanced_regression_tpu_torch.ops.lds import prepare_weights_hist
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig

V, D_WORD, D_HID, N, BATCH = 31, 6, 4, 40, 8
D_PAIR = 8 * D_HID
FDS_FIELDS = ("running_mean", "running_var", "running_mean_last_epoch", "running_var_last_epoch",
              "smoothed_mean_last_epoch", "smoothed_var_last_epoch", "num_samples_tracked")


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _dataset(rng):
    """N pairs with skewed scores (some of the 50 buckets empty), LDS
    inverse weights and histogram bucket indices."""
    target = np.round(5.0 * rng.beta(2.0, 5.0, N), 3).astype(np.float32)
    weight = prepare_weights_hist(target, "inverse", lds=True, lds_sigma=2.0)
    return {"input": pair_input(rng, N, 9, 7, V), "target": target[:, None],
            "weight": weight[:, None], "bucket_idx": bin_index_hist_np(target, 50)}


def _random_fds(rng):
    b, d = 50, D_PAIR
    return {
        "epoch": np.asarray(1, np.int32),
        "running_mean": rng.normal(size=(b, d)).astype(np.float32) * 0.1,
        "running_var": rng.uniform(0.01, 0.2, size=(b, d)).astype(np.float32),
        "running_mean_last_epoch": rng.normal(size=(b, d)).astype(np.float32) * 0.1,
        "running_var_last_epoch": rng.uniform(0.01, 0.2, size=(b, d)).astype(np.float32),
        "smoothed_mean_last_epoch": rng.normal(size=(b, d)).astype(np.float32) * 0.1,
        "smoothed_var_last_epoch": rng.uniform(0.01, 0.2, size=(b, d)).astype(np.float32),
        "num_samples_tracked": rng.integers(0, 50, size=b).astype(np.float32),
    }


def _port_trainer(table, dropout=0.0, seed=0):
    encoder = PairBiLSTMEncoder(V, D_WORD, D_HID, 2, dropout=dropout, dropout_embs=dropout,
                                embedding_table=table)
    trainer = Trainer(encoder, RegressionHead(D_PAIR),
                      TrainerConfig(loss="mse", lr=1e-3, clip_grad_norm=5.0, target_scale=5.0,
                                    schedule=()),
                      fds_config=FDSConfig.for_sts(feature_dim=D_PAIR, start_smooth=0),
                      device="cpu")
    return trainer, trainer.init_state(seed)


@pytest.fixture
def pair():
    """The JAX and the port's Trainer on the same weights and FDS state."""
    rng = np.random.default_rng(0)
    data = _dataset(rng)
    table = rng.normal(size=(V, D_WORD)).astype(np.float32)
    table[0] = 0.0
    jtrainer = JTrainer(
        JEncoder(vocab_size=V, d_word=D_WORD, d_hid=D_HID, n_layers=2, dropout=0.0,
                 dropout_embs=0.0, embedding_table=table),
        JHead(),
        JTrainerConfig(loss="mse", lr=1e-3, clip_grad_norm=5.0, target_scale=5.0, schedule=()),
        fds_config=JFDSConfig.for_sts(feature_dim=D_PAIR, start_smooth=0), mesh=create_mesh(1))
    jstate = jtrainer.init_state(jax.random.key(0), jax.tree.map(lambda v: v[:2], data["input"]))
    fds_np = _random_fds(rng)
    jstate = jstate.replace(fds=jstate.fds.replace(**{k: jnp.asarray(v) for k, v in fds_np.items()}))
    trainer, state = _port_trainer(table)
    sd = stsb_from_flax(jax.tree.map(np.asarray, {"params": jstate.params["backbone"]}),
                        jax.tree.map(np.asarray, jstate.params["head"]))
    state.backbone.load_state_dict(sd["backbone"])
    state.head.load_state_dict(sd["head"])
    state.fds = fds_state_from_numpy(fds_np, device="cpu")
    jtrainer.bind_device_data(data)
    trainer.bind_device_data(data)
    return jtrainer, jstate, trainer, state, data


def test_indexed_steps_and_stats_pass_match_jax(pair):
    """Three steps at epoch 1 (calibrating with the injected statistics),
    then the stats pass of epoch 2 on the trained weights."""
    jtrainer, jstate, trainer, state, _ = pair
    for idx in list(j_index_iterator(N, BATCH, rng=np.random.default_rng(1)))[:3]:
        jstate, jloss, jpred = jtrainer.train_step_indexed(jstate, idx, 1)
        state, loss, pred = trainer.train_step_indexed(state, idx, 1)
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert state.step == 3
    jfds = jtrainer.fds_epoch_pass_indexed(
        jstate, j_index_iterator(N, BATCH, rng=np.random.default_rng(7)), 2).fds
    fds = trainer.fds_epoch_pass_indexed(
        state, index_iterator(N, BATCH, rng=np.random.default_rng(7)), 2).fds
    assert fds.epoch == int(jfds.epoch) == 2
    for f in FDS_FIELDS:
        want = np.asarray(getattr(jfds, f))
        np.testing.assert_allclose(getattr(fds, f).numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=f)


def test_indexed_step_equals_host_batch_step():
    """Two trainers from the same seed, with dropout 0.2: one indexed, one
    on the host batches the same indices gather; equal losses, predictions,
    weights, generator state and FDS state after two steps and a pass."""
    data = _dataset(np.random.default_rng(5))
    a, sa = _port_trainer(None, dropout=0.2, seed=3)
    b, sb = _port_trainer(None, dropout=0.2, seed=3)
    a.bind_device_data(data)
    take = lambda idx: tree_map(lambda v: v[idx], data)  # noqa: E731
    for epoch in (0, 1):
        for idx in list(index_iterator(N, BATCH, rng=np.random.default_rng(epoch)))[:2]:
            sa, la, pa = a.train_step_indexed(sa, idx, epoch)
            sb, lb, pb = b.train_step(sb, take(idx), epoch)
            assert torch.equal(la, lb) and torch.equal(pa, pb)
        idx = list(index_iterator(N, BATCH, rng=np.random.default_rng(9)))
        sa = a.fds_epoch_pass_indexed(sa, idx, epoch)
        sb = b.fds_epoch_pass(sb, [take(i) for i in idx], epoch)
    for (ka, va), (kb, vb) in zip(sa.backbone.state_dict().items(), sb.backbone.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())
    for f in FDS_FIELDS:
        assert torch.equal(getattr(sa.fds, f), getattr(sb.fds, f)), f
    assert not torch.equal(sa.fds.running_mean_last_epoch,
                           torch.zeros_like(sa.fds.running_mean_last_epoch))


def test_unbound_trainer_refuses_indexed_steps():
    trainer, state = _port_trainer(None)
    with pytest.raises(AssertionError, match="bind_device_data"):
        trainer.train_step_indexed(state, np.arange(BATCH), 0)


def test_nested_predict():
    """Eval batches of nested inputs, the last one padded."""
    data = _dataset(np.random.default_rng(6))
    trainer, state = _port_trainer(None)
    preds, targets = trainer.predict(state, eval_batches(data, 16))
    assert preds.shape == targets.shape == (N, 1) and np.isfinite(preds).all()
    np.testing.assert_array_equal(targets, data["target"])
