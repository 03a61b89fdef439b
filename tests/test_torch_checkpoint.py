"""The port's checkpoints (``utils/checkpoint.py``) on the CPU: the round trip
is bit-exact (weights, BN buffers, Adam's moments and step, FDS state, step,
generator) and the next step after a restore is the uninterrupted one's; the
four RRT backbone-only loads of the JAX package's ``tests/test_checkpoint.py``;
a killed save keeps the previous file; the metric-history files; the meters
copy against the JAX package's; and ``train_epoch(start_step=k)`` after a
restore bit-identical to the uninterrupted epoch (as the JAX package's
``tests/test_midepoch_resume.py`` holds its trainer)."""

import itertools
import logging

import numpy as np
import pytest
import torch

from imbalanced_regression_tpu.utils import meters as jmeters
from imbalanced_regression_tpu_torch.data.augment import random_crop_flip_normalize
from imbalanced_regression_tpu_torch.data.batching import batch_iterator
from imbalanced_regression_tpu_torch.data.synthetic import synthetic_age_dataset
from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.models.resnet import RegressionHead, ResNetBasicBackbone
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig
from imbalanced_regression_tpu_torch.utils import checkpoint as ckpt
from imbalanced_regression_tpu_torch.utils import meters

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


def _trainer(fds=True, **kw):
    """The JAX tests' tiny model: a BasicBlock ResNet at stage sizes (1, 1),
    width 8 (16-d encoding), float32, with the age augmentation on."""
    return Trainer(ResNetBasicBackbone(stage_sizes=(1, 1), width=8, dtype=torch.float32),
                   RegressionHead(16), TrainerConfig(loss="mse", lr=1e-3, **kw),
                   fds_config=FDSConfig.for_age(feature_dim=16, bucket_num=121) if fds else None,
                   train_augment=random_crop_flip_normalize, device="cpu")


def _data():
    return synthetic_age_dataset(n=32, img_size=16, seed=5)


def _trained_state(trainer):
    data = _data()
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    state, _ = trainer.train_epoch(state, batch_iterator(data, 16, rng=rng), 0)
    state = trainer.fds_epoch_pass(state, batch_iterator(data, 16, rng=rng), 1)
    return state


def _assert_modules_equal(a, b):
    for part in ("backbone", "head"):
        sa, sb = getattr(a, part).state_dict(), getattr(b, part).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{part}.{k}"


def _assert_fds_equal(a, b):
    assert a.epoch == b.epoch
    for f in FDS_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_checkpoint_roundtrip_is_bit_exact(tmp_path):
    trainer = _trainer()
    state = _trained_state(trainer)
    ckpt.save_checkpoint(str(tmp_path), state, epoch=1, best_loss=3.25, is_best=True)

    fresh = _trainer().init_state(42)
    restored, epoch, best = ckpt.restore_checkpoint(str(tmp_path), fresh, which="latest")
    assert (epoch, best) == (1, 3.25)
    assert restored.step == state.step == 2
    _assert_modules_equal(restored, state)
    _assert_fds_equal(restored.fds, state.fds)
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    for p, q in zip(state.optimizer.param_groups[0]["params"],
                    restored.optimizer.param_groups[0]["params"]):
        want, got = state.optimizer.state[p], restored.optimizer.state[q]
        assert want.keys() == got.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in want:
            assert torch.equal(got[k], want[k]), k
    best_state, best_epoch, _ = ckpt.restore_checkpoint(str(tmp_path), _trainer().init_state(7),
                                                        which="best")
    assert best_epoch == 1
    _assert_fds_equal(best_state.fds, state.fds)

    # the next step (augmentation drawn from the restored generator, Adam at
    # step 3) is the one the saved state takes
    batch = {k: v[:16] for k, v in _data().items()}
    restored, loss_r, _ = trainer.train_step(restored, batch, 1)
    state, loss, _ = trainer.train_step(state, batch, 1)
    assert torch.equal(loss_r, loss)
    _assert_modules_equal(restored, state)
    assert ckpt.state_byte_size(state) == sum(
        t.numel() * t.element_size() for t in itertools.chain(
            state.backbone.state_dict().values(), state.head.state_dict().values(),
            (v for s in state.optimizer.state.values() for v in s.values()),
            (getattr(state.fds, f) for f in FDS_FIELDS)))


def test_load_backbone_only(tmp_path):
    trainer = _trainer()
    state = _trained_state(trainer)
    ckpt.save_checkpoint(str(tmp_path), state, epoch=1, best_loss=1.0, is_best=True)
    fresh = _trainer().init_state(7)
    head = {k: v.clone() for k, v in fresh.head.state_dict().items()}
    loaded = ckpt.load_backbone_params(str(tmp_path), fresh)
    for k, v in state.backbone.state_dict().items():  # weights and BN buffers
        assert torch.equal(loaded.backbone.state_dict()[k], v), k
    # the trained head is dropped (train.py:174-183), the optimizer untouched
    for k, v in head.items():
        assert torch.equal(loaded.head.state_dict()[k], v), k
    assert not loaded.optimizer.state


def test_load_backbone_across_optimizers(tmp_path):
    """The RRT flow: stage 1 saves with Adam over every parameter, stage 2
    (``retrain_fc``, SGD over the head) loads the backbone only, then trains
    with the backbone frozen."""
    state = _trained_state(_trainer())
    ckpt.save_checkpoint(str(tmp_path), state, epoch=1, best_loss=1.0, is_best=True)
    stage2 = _trainer(retrain_fc=True, optimizer="sgd")
    loaded = ckpt.load_backbone_params(str(tmp_path), stage2.init_state(7))
    before = {k: v.clone() for k, v in loaded.backbone.named_parameters()}
    for k, v in before.items():
        assert torch.equal(v, state.backbone.state_dict()[k]), k
    head_before = loaded.head.linear.weight.detach().clone()
    out, _ = stage2.train_epoch(loaded, batch_iterator(_data(), 16,
                                                       rng=np.random.default_rng(1)), 0)
    for k, v in out.backbone.named_parameters():
        assert torch.equal(v, before[k]), k  # frozen
    assert not torch.equal(out.head.linear.weight, head_before)


def test_load_backbone_restores_fds_stats(tmp_path):
    """Age-suite RRT: the FDS running statistics load with the backbone
    (imdb-wiki-dir/train.py:174-183); ``restore_fds=False`` (STS) keeps the
    fresh ones."""
    state = _trained_state(_trainer())
    ckpt.save_checkpoint(str(tmp_path), state, epoch=1, best_loss=1.0, is_best=True)
    fresh = _trainer().init_state(7)
    _assert_fds_equal(ckpt.load_backbone_params(str(tmp_path), fresh).fds, state.fds)
    fresh = _trainer().init_state(7)
    kept = ckpt.load_backbone_params(str(tmp_path), fresh, restore_fds=False)
    assert float(kept.fds.num_samples_tracked.sum()) == 0 and kept.fds.epoch == 0


def test_load_backbone_fds_fallback_on_vanilla_checkpoint(tmp_path):
    """A stage-1 checkpoint trained without FDS has none: the FDS-enabled
    stage 2 keeps its fresh statistics."""
    vanilla = _trainer(fds=False)
    state = vanilla.init_state(0)
    state, _ = vanilla.train_epoch(state, batch_iterator(_data(), 16,
                                                         rng=np.random.default_rng(0)), 0)
    ckpt.save_checkpoint(str(tmp_path), state, epoch=1, best_loss=1.0, is_best=True)
    assert ckpt.read_checkpoint(str(tmp_path), "best")["fds"] is None
    loaded = ckpt.load_backbone_params(str(tmp_path), _trainer(retrain_fc=True).init_state(7))
    for k, v in state.backbone.state_dict().items():
        assert torch.equal(loaded.backbone.state_dict()[k], v), k
    assert float(loaded.fds.num_samples_tracked.sum()) == 0


def test_killed_save_keeps_previous_checkpoint(tmp_path, monkeypatch):
    trainer = _trainer()
    state = _trained_state(trainer)
    ckpt.save_checkpoint(str(tmp_path), state, epoch=1, best_loss=2.0, is_best=True)

    def dying_save(obj, path):
        with open(path, "wb") as fh:
            fh.write(b"half a checkpoint")
        raise KeyboardInterrupt("killed during the save")

    monkeypatch.setattr(ckpt.torch, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_checkpoint(str(tmp_path), state, epoch=2, best_loss=1.0, is_best=True)
    for which in ("latest", "best"):
        assert ckpt.read_checkpoint(str(tmp_path), which)["meta"] == {"epoch": 1, "best_loss": 2.0}


def test_metric_state_roundtrip(tmp_path):
    assert ckpt.load_metric_state(str(tmp_path)) is None
    ckpt.save_metric_state(str(tmp_path), [0.5, 0.25], 0.25, is_best=True)
    ckpt.save_metric_state(str(tmp_path), [0.5, 0.25, 0.75], 0.25, is_best=False)
    assert ckpt.load_metric_state(str(tmp_path)) == {"hist": [0.5, 0.25, 0.75], "best": 0.25}
    assert ckpt.load_metric_state(str(tmp_path), "best") == {"hist": [0.5, 0.25], "best": 0.25}


def test_meters_match_jax(caplog):
    got, want = meters.AverageMeter("Loss", ":.4f"), jmeters.AverageMeter("Loss", ":.4f")
    for val, n in ((1.5, 4), (0.25, 2), (3.0, 1)):
        got.update(val, n)
        want.update(val, n)
        assert str(got) == str(want)
    assert (got.avg, got.count) == (want.avg, want.count)
    with caplog.at_level(logging.INFO):
        meters.ProgressMeter(120, [got], prefix="Epoch: [3]").display(7)
        jmeters.ProgressMeter(120, [want], prefix="Epoch: [3]").display(7)
    assert caplog.records[0].getMessage() == caplog.records[1].getMessage()


def test_train_epoch_start_step_matches_uninterrupted(tmp_path):
    """Checkpoint after step k (from the step hook), restore into a fresh
    trainer, finish the epoch with ``start_step=k`` over the same seeded
    stream: weights, BN buffers, Adam state, FDS state and generator are
    bit-identical to the uninterrupted epoch's."""
    data = synthetic_age_dataset(n=96, img_size=16, seed=0)
    k = 3  # of 6 steps
    batches = lambda: batch_iterator(data, 16, rng=np.random.default_rng((0, 0)))  # noqa: E731
    trainer = _trainer()
    full, _ = trainer.train_epoch(trainer.init_state(0), batches(), 1)

    seen = []

    def hook(state, step):
        seen.append(step)
        if step == k:
            ckpt.save_checkpoint(str(tmp_path), state, 1, 1e5, is_best=False)

    trainer_b = _trainer()
    trainer_b.train_epoch(trainer_b.init_state(0), itertools.islice(batches(), k + 1), 1,
                          step_hook=hook, hook_every=k)
    assert seen == [k]

    trainer_c = _trainer()
    restored, epoch, _ = ckpt.restore_checkpoint(str(tmp_path), trainer_c.init_state(5))
    assert epoch == 1 and restored.step == k
    resumed, _ = trainer_c.train_epoch(restored, batches(), 1, start_step=k)
    assert resumed.step == full.step == 6
    _assert_modules_equal(resumed, full)
    _assert_fds_equal(resumed.fds, full.fds)
    assert torch.equal(resumed.generator.get_state(), full.generator.get_state())
    for p, q in zip(full.optimizer.param_groups[0]["params"],
                    resumed.optimizer.param_groups[0]["params"]):
        for key, v in full.optimizer.state[p].items():
            assert torch.equal(resumed.optimizer.state[q][key], v), key
