"""The port's STS-B driver with ``--encoder deepseek_v2`` on the CPU, at a
tiny DeepSeek-V2 (hidden 64, 3 layers of which 1 dense, 8 experts of width
32 with 2 held, top-3) on TSVs the test writes: a run to its stop with
checkpoints and a test of its best; the run killed right after a
validation check's checkpoint and resumed with ``--resume``, bit-equal to
the uninterrupted run (the same torch thread count on both sides);
``--evaluate``; the flags the encoder refuses; the BiLSTM staying the
default encoder. This file imports neither jax nor the JAX package."""

import os

import numpy as np
import pytest
import torch
from torch_stsb_tiny import write_tiny_tsvs

from imbalanced_regression_tpu_torch.models.deepseek_v2 import PairMoEEncoder
from imbalanced_regression_tpu_torch.tasks import stsb
from imbalanced_regression_tpu_torch.utils.checkpoint import checkpoint_meta, read_checkpoint

MODEL = ["--encoder", "deepseek_v2", "--glove", "0", "--vocab_size", "64", "--hidden_size", "64",
         "--num_hidden_layers", "3", "--intermediate_size", "96", "--moe_intermediate_size", "32",
         "--n_routed_experts", "8", "--experts_held", "2", "--expert_rank", "3",
         "--num_experts_per_tok", "3", "--num_attention_heads", "4", "--kv_lora_rank", "32",
         "--qk_nope_head_dim", "16", "--qk_rope_head_dim", "16", "--v_head_dim", "16"]


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("stsb_moe")
    write_tiny_tsvs(str(d), n_train=40, n_eval=10)
    return str(d)


def _argv(data_dir, root, *extra):
    """Batch 8 (5 steps an epoch), a check every 3 iterations, FDS from
    epoch 1 with LDS weights."""
    return ["--data_dir", data_dir, "--device", "cpu", *MODEL, "--max_seq_len", "10",
            "--batch_size", "8", "--val_interval", "3", "--max_vals", "4", "--patience", "2",
            "--lr", "1e-3", "--fds", "--lds", "--reweight", "inverse", "--store_root", str(root),
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


def test_trains_checkpoints_and_tests(full_run):
    argv, result = full_run
    encoder = result["trainer"].backbone
    assert isinstance(encoder, PairMoEEncoder) and encoder.dtype == torch.bfloat16
    assert result["state"].fds.running_mean.shape[1] == 4 * 64 == encoder.out_features
    hist = result["val_history"]
    assert result["iterations"] == 3 * len(hist) and result["best_val_mse"] == min(hist)
    assert all(np.isfinite(c["train_loss"]) for c in result["checks"])
    assert encoder.routed_rows.shape == (2, 2) and encoder.routed_rows.sum() > 0
    store = _store(argv)
    assert store.endswith("_deepseek_v2")  # not a BiLSTM run's store
    assert checkpoint_meta(store, "latest")["metric_state"]["hist"] == hist
    keys = read_checkpoint(store, "best")["backbone"].keys()
    assert "layers.1.mlp.experts_gate_up" in keys and "routed_rows" not in keys
    assert np.load(os.path.join(store, "sts.npz"))["preds"].shape == (10,)


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
    resumed = stsb.main(argv + ["--resume", _store(argv)])
    for key in ("test", "best_val_mse", "iterations", "val_history"):
        _assert_equal(resumed[key], full[key], key)
    for which in ("latest", "best"):
        _assert_equal(read_checkpoint(_store(argv), which), read_checkpoint(_store(full_argv), which),
                      which)
    evaluated = stsb.main(argv + ["--evaluate", "--resume", _store(argv)])
    _assert_equal(evaluated["test"], full["test"], "test")


@pytest.mark.parametrize("flag,value", [("--glove", "1"), ("--n_layers_highway", "1"),
                                        ("--num_devices", "2")])
def test_refuses_unported_combinations(data_dir, tmp_path, flag, value):
    argv = _argv(data_dir, tmp_path) + [flag, value]
    with pytest.raises(NotImplementedError, match="deepseek_v2"):
        stsb.main(argv)


def test_refuses_a_vocabulary_larger_than_the_embedding(data_dir, tmp_path):
    with pytest.raises(ValueError, match="vocab_size"):
        stsb.main(_argv(data_dir, tmp_path) + ["--vocab_size", "8"])


def test_bilstm_stays_the_default_encoder():
    config = stsb.parse_sts_config([])
    assert config.encoder == "bilstm" and config.d_hid == 1500
    # the deepseek_v2 flags default to the published DeepSeek-V2-Lite
    shape = stsb.model_config(config)
    assert (shape.hidden_size, shape.num_hidden_layers, shape.n_routed_experts,
            shape.num_experts_per_tok, shape.experts_held) == (2048, 27, 64, 6, 64)
