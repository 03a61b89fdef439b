"""The port's drivers with checkpoints on the CPU, at tiny sizes: the age and
NYUD2 drivers killed right after a mid-epoch save and resumed give the
uninterrupted run's test metrics and checkpoints bit for bit (as the JAX
package's ``tests/test_midepoch_resume.py`` holds its drivers);
``--evaluate`` reproduces the best epoch's test; the two-stage RRT
(``--save_ckpt 1``, then ``--retrain_fc --pretrained``) on both drivers; and
which flags ``check_supported`` still refuses."""

import dataclasses

import numpy as np
import pytest
import torch

from imbalanced_regression_tpu_torch.models.resnet import ResNetBasicBackbone
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.tasks import age, nyud2
from imbalanced_regression_tpu_torch.utils.checkpoint import has_checkpoint, read_checkpoint
from imbalanced_regression_tpu_torch.utils.config import ExperimentConfig


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tiny_resnet(dtype, remat=None):
    """The JAX resume tests' model: one BasicBlock stage of width 8 (an
    8-d encoding), float32."""
    return ResNetBasicBackbone(stage_sizes=(1,), width=8, dtype=torch.float32, remat=remat)


@pytest.fixture(autouse=True)
def _tiny_models(monkeypatch):
    monkeypatch.setitem(age.BACKBONES, "resnet50", (_tiny_resnet, 8))
    # the NYUD2 synthetic images at 64x96 (depth 32x48), not the 228x304 crop
    monkeypatch.setattr(nyud2, "IMG_HW", (64, 96))
    monkeypatch.setattr(nyud2, "DEPTH_HW", (32, 48))


def _age_config(root, **kw):
    """128 synthetic images: 89 train (5 steps of 16), 19 val, 20 test."""
    base = dict(device="cpu", dataset="synthetic", synthetic_size=128, img_size=16, batch_size=16,
                epoch=2, lr=1e-3, loss="mse", store_root=str(root), fds=True, bucket_num=121,
                lds=True, reweight="sqrt_inv", ckpt_every_steps=2)
    return ExperimentConfig(**{**base, **kw})


def _nyud_config(root, **kw):
    """16 synthetic images: 12 train (3 steps of 4), an FDS subset of 3, 4
    test."""
    base = dict(device="cpu", synthetic_size=16, batch_size=4, test_batch_size=4, epoch=2,
                store_root=str(root), lds=True, reweight="inverse", fds=True,
                stage_sizes=(1, 1, 1, 1), width=8, lr=1e-3, ckpt_every_steps=1)
    return nyud2.NYUDConfig(**{**base, **kw})


def _store(config):
    return f"{config.store_root}/{config.derived_store_name()}"


def _assert_payloads_equal(a, b, path=""):
    """Two checkpoint payloads (nested dicts of tensors and numbers) equal
    bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_payloads_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_payloads_equal(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _killed_then_resumed(module, config, monkeypatch, kill_at: int):
    """Run ``module`` until its ``kill_at``-th checkpoint save has been
    written, raise there (the process dies), then resume from the store."""
    real_save = module.save_checkpoint
    calls = {"n": 0}

    def dying_save(store_dir, state, epoch, best, is_best):
        real_save(store_dir, state, epoch, best, is_best)
        calls["n"] += 1
        if calls["n"] == kill_at:
            raise RuntimeError("killed after a mid-epoch checkpoint")

    monkeypatch.setattr(module, "save_checkpoint", dying_save)
    with pytest.raises(RuntimeError, match="killed after"):
        module.run(config)
    monkeypatch.setattr(module, "save_checkpoint", real_save)
    assert has_checkpoint(_store(config), "latest")
    return module.run(dataclasses.replace(config, resume=_store(config)))


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """The uninterrupted age run with checkpoints (RRT stage 1), with the
    tests' two threads: another count reduces the CPU convolutions in
    another order, and the bits differ."""
    root = tmp_path_factory.mktemp("uninterrupted")
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(age.BACKBONES, "resnet50", (_tiny_resnet, 8))
            return _age_config(root), age.run(_age_config(root))
    finally:
        torch.set_num_threads(before)


def test_age_driver_killed_midepoch_resumes_identically(tmp_path, monkeypatch, stage1):
    config, want = stage1
    # the 2nd save is epoch 0's step 4 of 5
    got = _killed_then_resumed(age, _age_config(tmp_path), monkeypatch, kill_at=2)
    assert [h["epoch"] for h in got["history"]] == [0, 1]
    for key in ("mse", "l1", "gmean"):
        assert got["test"][key] == want["test"][key], key
    assert got["best_loss"] == want["best_loss"]
    for which in ("latest", "best"):
        _assert_payloads_equal(read_checkpoint(_store(_age_config(tmp_path)), which),
                               read_checkpoint(_store(config), which), which)


def test_age_evaluate_reproduces_best_test(stage1):
    config, want = stage1
    got = age.run(dataclasses.replace(config, evaluate=True, resume=_store(config)))
    np.testing.assert_equal(got["test"], want["test"])


def test_retrain_fc_needs_pretrained(tmp_path):
    with pytest.raises(AssertionError, match="pretrained"):
        age.run(_age_config(tmp_path, retrain_fc=True))


def test_age_rrt_two_stage(tmp_path, monkeypatch, stage1):
    """Stage 2 (``--retrain_fc --pretrained <stage-1 store>``, SGD): the
    backbone's weights stay the stage-1 best's bit for bit, the head moves,
    epoch 1 calibrates with the restored FDS snapshot and no calibration
    backward runs; ``--evaluate`` on stage 2's store gives its final test."""
    config1, _ = stage1
    best1 = read_checkpoint(_store(config1), "best")
    assert best1["meta"]["epoch"] == 2, "stage 1's best is its last epoch"
    calls = {"calibrate_forward": 0, "calibrate_backward": 0}
    for name in calls:
        real = getattr(ck, name)

        def counted(*a, _name=name, _real=real):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(ck, name, counted)
    config = _age_config(tmp_path, retrain_fc=True, pretrained=_store(config1), optimizer="sgd",
                         ckpt_every_steps=0)
    result = age.run(config)
    assert calls["calibrate_forward"] > 0 and calls["calibrate_backward"] == 0
    assert all(np.isfinite(h["train_loss"]) for h in result["history"])
    assert result["history"][1]["fds_calibrating"]
    for which in ("latest", "best"):
        got = read_checkpoint(_store(config), which)
        for k, v in best1["backbone"].items():
            if "running" not in k:
                assert torch.equal(got["backbone"][k], v), k
        # the last-epoch snapshot that epoch 1 calibrated with is stage 1's
        assert torch.equal(got["fds"]["running_mean_last_epoch"],
                           best1["fds"]["running_mean_last_epoch"])
        assert not torch.equal(got["head"]["linear.weight"], best1["head"]["linear.weight"])
    evaluated = age.run(dataclasses.replace(config, evaluate=True, resume=_store(config)))
    np.testing.assert_equal(evaluated["test"], result["test"])


def test_nyud2_driver_killed_midepoch_resumes_identically(tmp_path, monkeypatch):
    want = nyud2.run(_nyud_config(tmp_path / "uninterrupted"))
    # the 2nd save is epoch 0's step 2 of 3
    got = _killed_then_resumed(nyud2, _nyud_config(tmp_path / "resumed"), monkeypatch, kill_at=2)
    for key in ("RMSE", "MAE", "ABS_REL", "DELTA1"):
        assert got["test"]["overall"][key] == want["test"]["overall"][key], key
    assert got["best_epoch"] == want["best_epoch"] and got["best_rmse"] == want["best_rmse"]
    for which in ("latest", "best"):
        _assert_payloads_equal(read_checkpoint(_store(_nyud_config(tmp_path / "resumed")), which),
                               read_checkpoint(_store(_nyud_config(tmp_path / "uninterrupted")),
                                               which), which)
    # --evaluate tests the best checkpoint: the run's own best test
    config = _nyud_config(tmp_path / "uninterrupted")
    evaluated = nyud2.run(dataclasses.replace(config, evaluate=True, resume=_store(config)))
    # (a shot with no pixel has NaN metrics, which assert_equal matches)
    np.testing.assert_equal(evaluated["test"], want["test"])


def test_nyud2_rrt_freezes_the_encoder_decoder(tmp_path):
    stage1 = _nyud_config(tmp_path / "stage1", epoch=1, ckpt_every_steps=0)
    nyud2.run(stage1)
    config = _nyud_config(tmp_path / "stage2", epoch=1, ckpt_every_steps=0, retrain_fc=True,
                          pretrained=_store(stage1))
    result = nyud2.run(config)
    best1, got = read_checkpoint(_store(stage1), "best"), read_checkpoint(_store(config), "latest")
    for k, v in best1["backbone"].items():
        if "running" not in k:
            assert torch.equal(got["backbone"][k], v), k
    assert not torch.equal(got["head"]["conv.weight"], best1["head"]["conv.weight"])
    assert np.isfinite(result["best_rmse"])


@pytest.mark.parametrize("flags", [dict(resume="x"), dict(evaluate=True), dict(pretrained="x"),
                                   dict(retrain_fc=True), dict(ckpt_every_steps=5),
                                   dict(save_ckpt=1), dict(optimizer="sgd"),
                                   dict(remat="conv_outs")])
def test_ported_flags_pass_the_check(flags):
    age.check_supported(ExperimentConfig(synthetic_size=8, **flags))
    if "optimizer" not in flags and "remat" not in flags:
        nyud2.check_supported(nyud2.NYUDConfig(**flags))
