"""The port's STS-B driver on the CPU, at a tiny width on TSVs the test
writes: a run to its patience stop; a run killed right after a validation
check's checkpoint and resumed with ``--resume``, bit-equal to the
uninterrupted run (the same torch thread count on both sides);
``--evaluate``; RRT stage 2 (``--retrain_fc --pretrained``: the encoder
stays bit-equal to stage 1's best, K2's plain version is never called, the
FDS statistics are not restored); ``export_predictions`` against the JAX
function's npz; ``is_new_best`` on ties; the flags it refuses. With
``--lstm_impl flax`` (the per-direction BiLSTM): its checkpoints round-trip
through a kill and ``--resume``, and the layout is taken from the
checkpoint, without the flag, on ``--resume``, ``--evaluate`` and RRT
stage 2 (and a fused checkpoint overrides the flag the other way)."""

import json
import os

import numpy as np
import pytest
import torch
from torch_stsb_tiny import write_tiny_tsvs

from imbalanced_regression_tpu.tasks import stsb as jstsb
from imbalanced_regression_tpu_torch.fds import fds_init
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.tasks import stsb
from imbalanced_regression_tpu_torch.models import bilstm_pair as stsb_model
from imbalanced_regression_tpu_torch.utils.checkpoint import (
    checkpoint_lstm_impl,
    checkpoint_meta,
    read_checkpoint,
)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("stsb")
    write_tiny_tsvs(str(d), n_train=40, n_eval=10)
    return str(d)


def _argv(data_dir, root, *extra):
    """d_hid 8, one layer, batch 8 (5 steps an epoch), a check every 3
    iterations, FDS from epoch 1 with LDS weights."""
    return ["--data_dir", data_dir, "--device", "cpu", "--d_word", "8", "--d_hid", "8",
            "--n_layers_enc", "1", "--max_seq_len", "10", "--batch_size", "8",
            "--val_interval", "3", "--max_vals", "5", "--patience", "2", "--lr", "1e-2",
            "--glove", "0", "--fds", "--lds", "--reweight", "inverse", "--store_root", str(root),
            "--cache_dir", str(root) + "_cache", *extra]


def _store(argv):
    cfg = stsb.parse_sts_config(argv)
    return os.path.join(cfg.store_root, cfg.derived_store_name())


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b or (a != a and b != b), path


class Killed(Exception):
    pass


@pytest.fixture(scope="module")
def full_run(data_dir, tmp_path_factory):
    torch.set_num_threads(2)
    argv = _argv(data_dir, tmp_path_factory.mktemp("full"))
    return argv, stsb.main(argv)


def test_run_to_patience_stop(full_run):
    argv, result = full_run
    hist = result["val_history"]
    assert result["iterations"] == 3 * len(hist) and len(hist) < 5
    # out of patience: the last score is >= every score of the last 3 checks
    assert max(hist[-3:]) <= hist[-1]
    assert result["best_val_mse"] == min(hist)
    assert all(np.isfinite(c["train_loss"]) and c["pairs_per_sec"] > 0 for c in result["checks"])
    assert len(result["stats_pass_seconds"]) == result["iterations"] // 5
    store = _store(argv)
    npz = np.load(os.path.join(store, "sts.npz"))
    assert npz["preds"].shape == (10,) and npz["preds"].min() >= 0 and npz["preds"].max() <= 5
    meta = checkpoint_meta(store, "latest")
    assert meta["metric_state"] == {"hist": hist, "best": result["best_val_mse"]}
    fds = result["final_fds"]
    assert (fds.running_var_last_epoch != 1).any() and (fds.smoothed_mean_last_epoch != 0).any()
    # each check's log carries the spans' view of its interval: the median
    # step; the indexed mode gathers on the device and waits for no input
    with open(os.path.join(store, "metrics.jsonl")) as fh:
        logged = [json.loads(line) for line in fh]
    steps = {r["step"]: r["value"] for r in logged if r["tag"] == "step_host_ms"}
    assert sorted(steps) == list(range(1, len(hist) + 1)) and min(steps.values()) > 0
    assert {r["value"] for r in logged if r["tag"] == "input_wait_seconds"} == {0.0}


def test_killed_and_resumed_is_bit_equal(full_run, data_dir, tmp_path, monkeypatch):
    """Killed right after check 2's checkpoint (iteration 6, epoch 1, one
    stats pass behind it), then resumed."""
    full_argv, full = full_run
    argv = _argv(data_dir, tmp_path / "part")
    real_save, saves = stsb.save_checkpoint, []

    def dying_save(*args, **kwargs):
        real_save(*args, **kwargs)
        saves.append(1)
        if len(saves) == 2:
            raise Killed

    monkeypatch.setattr(stsb, "save_checkpoint", dying_save)
    with pytest.raises(Killed):
        stsb.main(argv)
    monkeypatch.setattr(stsb, "save_checkpoint", real_save)
    assert checkpoint_meta(_store(argv))["metric_state"]["hist"] == full["val_history"][:2]
    resumed = stsb.main(argv + ["--resume", _store(argv)])
    for key in ("test", "best_val_mse", "iterations", "val_history"):
        _assert_equal(resumed[key], full[key], key)
    for which in ("latest", "best"):
        _assert_equal(read_checkpoint(_store(argv), which), read_checkpoint(_store(full_argv), which),
                      which)
    # --evaluate tests the store's best, as the run's own final test did
    evaluated = stsb.main(argv + ["--evaluate", "--resume", _store(argv)])
    _assert_equal(evaluated["test"], full["test"])
    # by default it tests the run's own store dir
    _assert_equal(stsb.main(full_argv + ["--evaluate"])["test"], full["test"])


def test_rrt_stage_two(full_run, data_dir, tmp_path, monkeypatch):
    stage1_argv, _ = full_run
    stage1 = _store(stage1_argv)
    argv = _argv(data_dir, tmp_path / "rrt", "--retrain_fc", "--pretrained", stage1,
                 "--max_vals", "2")
    calls = {"k1": 0, "k2": 0}
    real_k1, real_k2 = ck.calibrate_indexed, ck.calibrate_indexed_grad

    def k1(*a, **k):
        calls["k1"] += 1
        return real_k1(*a, **k)

    def k2(*a, **k):
        calls["k2"] += 1
        return real_k2(*a, **k)

    monkeypatch.setattr(ck, "calibrate_indexed", k1)
    monkeypatch.setattr(ck, "calibrate_indexed_grad", k2)
    real_load, loaded = stsb.load_backbone_params, {}

    def recording_load(*args, **kwargs):
        state = real_load(*args, **kwargs)
        loaded["fds"] = state.fds
        loaded["head"] = {k: v.clone() for k, v in state.head.state_dict().items()}
        return state

    monkeypatch.setattr(stsb, "load_backbone_params", recording_load)
    result = stsb.main(argv)
    assert calls["k1"] > 0 and calls["k2"] == 0, calls
    # stage 1's best (check 2, after the first stats pass) has statistics;
    # stage 2 starts from fds_init's
    best1 = read_checkpoint(stage1, "best")
    assert (best1["fds"]["running_var"] != 1).any()
    fresh = fds_init(result["trainer"].fds_config, "cpu")
    for f in ("running_mean", "running_var", "running_mean_last_epoch", "num_samples_tracked"):
        assert torch.equal(getattr(loaded["fds"], f), getattr(fresh, f)), f
    for which in ("latest", "best"):
        stage2 = read_checkpoint(_store(argv), which)
        _assert_equal(stage2["backbone"], best1["backbone"], which)
    head = result["state"].head.state_dict()
    assert not torch.equal(head["linear.weight"], loaded["head"]["linear.weight"])


def test_export_predictions_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    preds = rng.normal(0.5, 0.6, size=(13, 1)).astype(np.float32)
    labels = rng.uniform(0, 5, size=(13, 1)).astype(np.float32)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = np.load(stsb.export_predictions(str(tmp_path / "a"), "run", preds, labels))
    theirs = np.load(jstsb.export_predictions(str(tmp_path / "b"), "run", preds, labels))
    assert ours.files == theirs.files
    for k in ours.files:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert ours["preds"].min() == 0.0 and ours["preds"].max() == 5.0


@pytest.mark.parametrize("history", [[1.0], [1.0, 1.0], [2.0, 1.0], [1.0, 2.0], [3.0, 1.0, 1.0],
                                     [3.0, 1.0, 0.5], [1.0, 2.0, 1.0]])
def test_is_new_best_needs_strict_improvement(history):
    assert stsb.is_new_best(history) == jstsb.is_new_best(history)


@pytest.mark.parametrize("flag,value", [("--num_devices", "2"), ("--max_steps_per_run", "5")])
def test_refuses_unported_flags(data_dir, tmp_path, flag, value):
    """Data parallelism is ported (``tests/test_torch_parallel.py``): what
    ``--num_devices 2`` still refuses, before any data is read or any rank
    starts, is a batch that the two ranks cannot split."""
    if flag == "--num_devices":
        with pytest.raises(ValueError, match="does not divide over --num_devices 2"):
            stsb.main(_argv(data_dir, tmp_path) + [flag, value, "--batch_size", "7"])
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        stsb.main(_argv(data_dir, tmp_path) + [flag, value])


def test_defaults_to_the_gpu(data_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    argv = [a for a in _argv(data_dir, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stsb.main(argv)


def test_config_matches_jax():
    """The recipe's defaults and flags are the JAX driver's."""
    ours, theirs = stsb.parse_sts_config([]), jstsb.parse_sts_config([])
    for name in ("lr", "batch_size", "loss", "bucket_num", "lds_sigma", "fds_sigma", "d_hid",
                 "d_word", "n_layers_enc", "max_seq_len", "max_grad_norm", "val_interval",
                 "patience", "max_vals", "dropout", "dropout_embs", "glove", "huber_beta"):
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.fixture(scope="module")
def flax_run(data_dir, tmp_path_factory):
    torch.set_num_threads(2)
    argv = _argv(data_dir, tmp_path_factory.mktemp("flax"), "--n_layers_enc", "2")
    return argv, stsb.main(argv + ["--lstm_impl", "flax"])


def test_flax_layout_trains_and_checkpoints(flax_run):
    argv, result = flax_run
    encoder = result["trainer"].backbone
    assert encoder.lstm_impl == "flax" and isinstance(encoder.bilstm, stsb_model.BiLSTM)
    assert all(np.isfinite(c["train_loss"]) for c in result["checks"])
    assert checkpoint_lstm_impl(_store(argv), "best") == "flax"
    sd = read_checkpoint(_store(argv), "latest")["backbone"]
    assert {"bilstm.input_kernels_1", "bilstm.recurrent_biases_1"} <= sd.keys()
    assert not any(k.startswith("bilstm.input_proj_") for k in sd)


def test_flax_layout_resume_and_evaluate_take_the_layout_from_the_checkpoint(
        flax_run, data_dir, tmp_path, monkeypatch):
    """Killed after check 2's checkpoint with ``--lstm_impl flax``, resumed
    without the flag: bit-equal to the uninterrupted run; then
    ``--evaluate`` without the flag reproduces its test metrics."""
    full_argv, full = flax_run
    argv = _argv(data_dir, tmp_path / "part", "--n_layers_enc", "2")
    real_save, saves = stsb.save_checkpoint, []

    def dying_save(*args, **kwargs):
        real_save(*args, **kwargs)
        saves.append(1)
        if len(saves) == 2:
            raise Killed

    monkeypatch.setattr(stsb, "save_checkpoint", dying_save)
    with pytest.raises(Killed):
        stsb.main(argv + ["--lstm_impl", "flax"])
    monkeypatch.setattr(stsb, "save_checkpoint", real_save)
    # the driver's logging setup replaces the root handlers: record the
    # override at the logger
    warnings = []
    monkeypatch.setattr(stsb.logger, "warning", lambda msg, *a: warnings.append(msg % a))
    resumed = stsb.main(argv + ["--resume", _store(argv)])
    assert len(warnings) == 1 and "latest was written with lstm_impl='flax'" in warnings[0]
    assert resumed["trainer"].backbone.lstm_impl == "flax"
    for key in ("test", "best_val_mse", "iterations", "val_history"):
        _assert_equal(resumed[key], full[key], key)
    for which in ("latest", "best"):
        _assert_equal(read_checkpoint(_store(argv), which),
                      read_checkpoint(_store(full_argv), which), which)
    evaluated = stsb.main(argv + ["--evaluate", "--resume", _store(argv)])
    assert len(warnings) == 2 and "best was written" in warnings[1]
    assert "overriding configured 'fused'" in warnings[1]
    _assert_equal(evaluated["test"], full["test"])
    # the run's own store dir, by default
    _assert_equal(stsb.main(full_argv + ["--evaluate"])["test"], full["test"])


def test_flax_layout_rrt_stage_two_and_fused_override(flax_run, full_run, data_dir, tmp_path):
    """RRT stage 2 on a flax-layout stage 1 without the flag trains the head
    on stage 1's per-direction encoder; ``--evaluate --lstm_impl flax`` on a
    fused store builds the fused layout."""
    stage1_argv, _ = flax_run
    stage1 = _store(stage1_argv)
    argv = _argv(data_dir, tmp_path / "rrt", "--n_layers_enc", "2", "--retrain_fc",
                 "--pretrained", stage1, "--max_vals", "2")
    result = stsb.main(argv)
    assert result["trainer"].backbone.lstm_impl == "flax"
    _assert_equal(read_checkpoint(_store(argv), "best")["backbone"],
                  read_checkpoint(stage1, "best")["backbone"])
    fused_argv, fused = full_run
    evaluated = stsb.main(fused_argv + ["--evaluate", "--lstm_impl", "flax"])
    _assert_equal(evaluated["test"], fused["test"])


@pytest.mark.parametrize("which", ["latest", "best"])
def test_match_ckpt_lstm_impl_probes(flax_run, tmp_path, which):
    """A missing checkpoint leaves the flag; a store with only ``best`` is
    probed at ``best`` on ``--resume``, as the JAX driver does."""
    argv, _ = flax_run
    store = _store(argv)
    cfg = stsb.parse_sts_config(argv)
    assert stsb.match_ckpt_lstm_impl(cfg, str(tmp_path), which).lstm_impl == "fused"
    assert stsb.match_ckpt_lstm_impl(cfg, store, which).lstm_impl == "flax"
    only_best = tmp_path / "only_best"
    only_best.mkdir()
    os.link(os.path.join(store, "best.pt"), only_best / "best.pt")
    resume_cfg = stsb.parse_sts_config(argv + ["--resume", str(only_best)])
    assert stsb.match_restored_layout(resume_cfg, str(tmp_path)).lstm_impl == "flax"


def test_flax_layout_store_freezes_bit_equal(flax_run):
    """``serving.export_predictor`` freezes the flax-layout run's restored
    best state; the artifact serves ``predict_batch``'s predictions."""
    from torch_stsb_tiny import pair_input

    from imbalanced_regression_tpu_torch.serving import export_predictor, load_predictor

    _, result = flax_run
    trainer, state = result["trainer"], result["state"]
    x = pair_input(np.random.default_rng(0), 4, 10, 8, state.backbone.embed.num_embeddings)
    predict = load_predictor(export_predictor(trainer, state, x, platforms=("cpu",)))
    want = trainer.predict_batch(state, {"input": x, "target": np.zeros((4, 1), np.float32)})
    np.testing.assert_array_equal(predict(x), want)
