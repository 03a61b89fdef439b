"""Data parallelism of the port (``parallel/``) on the CPU: two gloo ranks,
each a process started by ``parallel.launch.run_ranks`` (a ``file://``
store, so no socket leaves the host), held against one process and against
the JAX package's Trainer on a 2-device mesh, as the JAX package's
``tests/test_parallel.py`` holds its mesh against one device:

- ``shard_batch`` rows and order, ``replicate``, ``create_mesh`` refusing
  more devices than ranks;
- the global-batch ``BatchNorm`` against one process on the concatenated
  batch, and with one rank bit-equal to the plain layer;
- all-reduced FDS moments against the gathered ones (age grouping with an
  edge label seen by one rank only; depth grouping) and the age edge gate
  of ``fds_smooth``;
- augmentation and dropout draws under DP against the one-process rows;
- two epochs of the tiny-ResNet Trainer with the stats pass: DP against one
  process and against the JAX Trainer on ``create_mesh(2)``; the indexed
  step against the host batch; clipping; RRT; remat;
- ``dryrun_multichip(2, "cpu")``;
- the three drivers on two ranks: rank 0 alone writes the checkpoints,
  which load into a one-process run (and a one-process checkpoint resumes
  on two ranks); a batch the ranks cannot split is refused;
  ``--max_steps_per_run -1`` is accepted.

Each spawn of ranks has its own time limit, so a hung collective fails
one test instead of the suite."""

import concurrent.futures
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_parallel_ranks as ranks
from torch_stsb_tiny import write_tiny_tsvs

from imbalanced_regression_tpu.data import batch_iterator as jbatch_iterator
from imbalanced_regression_tpu.data import synthetic_age_dataset as jsynthetic_age_dataset
from imbalanced_regression_tpu.fds import FDSConfig as JFDSConfig
from imbalanced_regression_tpu.models.resnet import RegressionHead as JHead
from imbalanced_regression_tpu.models.resnet import ResNetBasicBackbone as JBasicBackbone
from imbalanced_regression_tpu.parallel.mesh import create_mesh as jcreate_mesh
from imbalanced_regression_tpu.train import Trainer as JTrainer
from imbalanced_regression_tpu.train import TrainerConfig as JTrainerConfig
from imbalanced_regression_tpu_torch.convert import from_flax
from imbalanced_regression_tpu_torch.data.stsb import load_stsb_datasets
from imbalanced_regression_tpu_torch.data.synthetic import synthetic_age_dataset
from imbalanced_regression_tpu_torch.fds import fds_bucket_moments, fds_smooth
from imbalanced_regression_tpu_torch.models.resnet import BatchNorm
from imbalanced_regression_tpu_torch.parallel.dryrun import dryrun_multichip
from imbalanced_regression_tpu_torch.parallel.launch import run_ranks, state_digest
from imbalanced_regression_tpu_torch.parallel.mesh import create_mesh
from imbalanced_regression_tpu_torch.tasks import age, nyud2, stsb
from imbalanced_regression_tpu_torch.utils.checkpoint import has_checkpoint, restore_checkpoint
from imbalanced_regression_tpu_torch.utils.config import ExperimentConfig

SPAWN_TIMEOUT_S = 150  # each spawn of ranks, start-up included
COLLECTIVE_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def spawn(fn, *args):
    return run_ranks(fn, ranks.WORLD, *args, backend="gloo", timeout_s=SPAWN_TIMEOUT_S,
                     collective_timeout_s=COLLECTIVE_TIMEOUT_S)


def both(results, key):
    """``key`` of every rank's result, concatenated along the rows."""
    return torch.cat([torch.as_tensor(r[key]) for r in results])


# ------------------------------------------------------------------ primitives


@pytest.fixture(scope="module")
def primitives():
    return spawn(ranks.primitives_rank)


def test_shard_batch_rows_and_order(primitives):
    for rank, r in enumerate(primitives):
        assert r["rank"] == rank and r["world_size"] == 2 and r["backend"] == "gloo"
        mine = slice(4 * rank, 4 * rank + 4)
        np.testing.assert_array_equal(r["shard"]["x"], np.arange(24).reshape(8, 3)[mine])
        np.testing.assert_array_equal(r["shard"]["nested"]["y"], np.arange(8)[mine])
        assert "7 rows does not divide over 2 ranks" in r["odd_batch"]


def test_create_mesh_refuses_more_devices_than_ranks(primitives):
    for r in primitives:
        assert "requested 3 devices, the process group has 2 ranks" in r["too_many"]
    # without a process group, more than one device needs more processes
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="need 2 processes"):
        create_mesh(2, device="cpu")


def test_replicate_broadcasts_rank_0(primitives):
    for r in primitives:
        weight, bias, extra = r["replicated"]
        assert torch.equal(weight, torch.ones(2, 3)) and torch.equal(bias, -torch.ones(2))
        assert torch.equal(extra, torch.zeros(4))


def test_gather_rows_and_mean(primitives):
    want = torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3] * 2)
    for r in primitives:
        assert torch.equal(r["gathered"], want)
        assert torch.equal(r["mean"], torch.tensor([0.5, 1.0]))


def _plain_bn():
    x, w, b, weights = ranks.bn_inputs()
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(w))
        bn.bias.copy_(torch.as_tensor(b))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.as_tensor(weights)).sum().backward()
    return bn, xt, y


def test_global_batch_norm_matches_one_process(primitives):
    """Two ranks' halves against one process on the whole batch: output,
    input gradient, weight and bias gradients (the ranks' sums: each rank's
    are its own rows') and the running buffers, float32 within 1e-5."""
    bn, xt, y = _plain_bn()
    got = [r["bn"] for r in primitives]
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), y.detach(), **tol)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]), xt.grad, **tol)
    torch.testing.assert_close(got[0]["dw"] + got[1]["dw"], bn.weight.grad, **tol)
    torch.testing.assert_close(got[0]["db"] + got[1]["db"], bn.bias.grad, **tol)
    for g in got:
        torch.testing.assert_close(g["running_mean"], bn.running_mean, **tol)
        torch.testing.assert_close(g["running_var"], bn.running_var, **tol)
    # the ranks' buffers are bit-identical
    assert torch.equal(got[0]["running_var"], got[1]["running_var"])


def test_batch_norm_on_one_rank_is_the_plain_layer():
    """A one-rank mesh keeps ``native_batch_norm``: bit-equal output,
    gradients and buffers; a deep copy of the layer shares the mesh."""
    bn, xt, y = _plain_bn()
    mesh = create_mesh(1, device="cpu")
    try:
        assert mesh.world_size == 1 and mesh.backend == "gloo"
        bn1 = BatchNorm(4)
        bn1.load_state_dict({**bn.state_dict(), "running_mean": torch.zeros(4),
                             "running_var": torch.ones(4)})
        bn1.mesh = mesh
        x, _, _, weights = ranks.bn_inputs()
        x1 = torch.as_tensor(x).requires_grad_(True)
        y1 = bn1(x1)
        (y1 * torch.as_tensor(weights)).sum().backward()
        # a copied module (serving copies one to another device) shares the
        # mesh: a process group cannot be copied
        assert copy.deepcopy(bn1).mesh is mesh
    finally:
        dist.destroy_process_group()
    assert torch.equal(y1, y) and torch.equal(x1.grad, xt.grad)
    assert torch.equal(bn1.weight.grad, bn.weight.grad) and torch.equal(bn1.bias.grad, bn.bias.grad)
    assert torch.equal(bn1.running_mean, bn.running_mean)
    assert torch.equal(bn1.running_var, bn.running_var)
    assert mesh.stats.calls == 0  # no collective on one rank


@pytest.mark.parametrize("grouping", ["age", "depth"])
def test_sharded_moments_match_gathered(primitives, grouping):
    """All-reduced moments of the ranks' halves against the whole batch's:
    counts exact, sums within 1e-5; in the age grouping each rank alone
    sees one edge label, and the global batch both."""
    cfg, feats, labels = (ranks.age_moments_inputs() if grouping == "age"
                          else ranks.depth_moments_inputs())
    want = fds_bucket_moments(cfg, torch.as_tensor(feats), torch.as_tensor(labels))
    for r in primitives:
        got = r[f"{grouping}_moments"]
        assert torch.equal(got["count"], want.count)
        torch.testing.assert_close(got["total"], want.total, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["total_sq"], want.total_sq, rtol=1e-5, atol=1e-5)
        assert bool(got["has_lo"]) and bool(got["has_hi"])
        assert bool(want.has_lo) and bool(want.has_hi)
    if grouping == "age":
        assert [r["age_local_edges"] for r in primitives] == [(True, False), (False, True)]


def test_smooth_edge_gate_sees_the_global_batch(primitives):
    """``fds_smooth`` on each rank's half gives the whole batch's rows,
    bit for bit: the age grouping's edge gate is or-ed over the ranks."""
    cfg, feats, labels = ranks.age_moments_inputs()
    want = fds_smooth(cfg, ranks.smooth_state(cfg), torch.as_tensor(feats),
                      torch.as_tensor(labels), epoch=1)
    assert torch.equal(both(primitives, "age_smooth"), want)


def test_sharded_draws_equal_one_process_rows(primitives):
    """Augmentation, head dropout, the pair encoder's dropout (two stacked
    columns) and the photometric jitter under DP: each rank's rows are the
    one-process rows, and the generator ends where it does there."""
    images, enc, pair = ranks.draw_inputs()
    generator = torch.Generator().manual_seed(5)
    want = ranks.draws(torch.as_tensor(images), torch.as_tensor(enc), torch.as_tensor(pair),
                       generator)
    for rank, r in enumerate(primitives):
        mine = ranks.rows(rank, 8)
        for key in ("augment", "head", "photometric"):
            assert torch.equal(r["draws"][key], want[key][mine]), key
        pair_rows = torch.cat([want["pair"][:8][mine], want["pair"][8:][mine]])
        assert torch.equal(r["draws"]["pair"], pair_rows)
        assert torch.equal(r["generator_state"], generator.get_state())


# ------------------------------------------------------------------ trainer


def _jax_trainer(n_devices):
    return JTrainer(JBasicBackbone(stage_sizes=(1, 1), width=8, dtype=jnp.float32), JHead(),
                    JTrainerConfig(loss="mse", lr=1e-3),
                    fds_config=JFDSConfig.for_age(feature_dim=16, bucket_num=121),
                    mesh=jcreate_mesh(n_devices))


def _jax_weights(jstate):
    variables = jax.tree.map(np.asarray, {"params": jstate.params["backbone"],
                                          "batch_stats": jstate.batch_stats})
    return from_flax(variables, jax.tree.map(np.asarray, jstate.params["head"]))


@pytest.fixture(scope="module")
def trainer_runs():
    """The JAX Trainer on a 2-device mesh (two epochs from its init), the
    port's ranks and the port's one process, all from the JAX init."""
    data = jsynthetic_age_dataset(n=64, img_size=16, seed=3)
    jtrainer = _jax_trainer(2)
    jstate = jtrainer.init_state(jax.random.key(0), data["input"][:2])
    weights = _jax_weights(jstate)
    # the ranks train while this process runs the JAX epochs
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        dp = pool.submit(spawn, ranks.trainer_rank, weights)
        jax_run = _jax_two_epochs(jtrainer, jstate, data)
        dp = dp.result()
    one = ranks.two_epochs(ranks.tiny_trainer(None),
                           weights, synthetic_age_dataset(n=64, img_size=16, seed=3))
    return {"weights": weights, "jax": jax_run, "dp": dp, "one": one}


def _jax_two_epochs(jtrainer, jstate, data):
    jlosses = []
    for epoch in range(2):
        jstate, loss = jtrainer.train_epoch(
            jstate, jbatch_iterator(data, 32, rng=np.random.default_rng(7)), epoch)
        jstate = jtrainer.fds_epoch_pass(
            jstate, jbatch_iterator(data, 32, rng=np.random.default_rng(7)), epoch)
        jlosses.append(float(loss))
    return {"losses": jlosses, "weights": _jax_weights(jstate),
            "running_mean": torch.tensor(np.array(jstate.fds.running_mean)),
            "num_samples_tracked": torch.tensor(np.array(jstate.fds.num_samples_tracked))}


def _assert_weights_close(got, want, **tol):
    for part in ("backbone", "head"):
        for k, v in want[part].items():
            torch.testing.assert_close(got[part][k], v, msg=f"{part}.{k}", **tol)


def test_dp_ranks_end_bit_identical(trainer_runs):
    a, b = (r["two_epochs"] for r in trainer_runs["dp"])
    for part in ("backbone", "head"):
        for k in a["weights"][part]:
            assert torch.equal(a["weights"][part][k], b["weights"][part][k]), k
    assert torch.equal(a["running_mean"], b["running_mean"])
    assert a["losses"] == b["losses"]


def test_dp_two_epochs_match_one_process(trainer_runs):
    """DP equals one process at the same global batch (test_parallel.py's
    bounds): losses rtol 1e-4, weights and BN buffers rtol 1e-4 / atol
    1e-5, the FDS running mean rtol 1e-4 / atol 1e-6, the FDS counts
    exactly."""
    dp, one = trainer_runs["dp"][0]["two_epochs"], trainer_runs["one"]
    np.testing.assert_allclose(dp["losses"], one["losses"], rtol=1e-4)
    _assert_weights_close(dp["weights"], one["weights"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dp["running_mean"], one["running_mean"], rtol=1e-4, atol=1e-6)
    assert torch.equal(dp["num_samples_tracked"], one["num_samples_tracked"])


def test_dp_two_epochs_match_jax_mesh(trainer_runs):
    """The port's two ranks against the JAX Trainer on a 2-device mesh, from
    the same (converted) weights, at test_parallel.py's bounds: losses rtol
    1e-4, weights and BN buffers rtol 1e-4 / atol 1e-5 (the largest gap
    seen on this host is 1.6e-6, of a weight that four Adam steps moved by
    up to 4e-3), the FDS running mean rtol 1e-4 / atol 1e-5 (5.3e-6 seen),
    the FDS counts exactly."""
    dp, jx = trainer_runs["dp"][0]["two_epochs"], trainer_runs["jax"]
    np.testing.assert_allclose(dp["losses"], jx["losses"], rtol=1e-4)
    _assert_weights_close(dp["weights"], jx["weights"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dp["running_mean"], jx["running_mean"], rtol=1e-4, atol=1e-5)
    assert torch.equal(dp["num_samples_tracked"], jx["num_samples_tracked"])


def test_indexed_step_dp_equals_host_batch_dp(trainer_runs):
    for r in trainer_runs["dp"]:
        host, idx = r["indexed"]["host"], r["indexed"]["indexed"]
        np.testing.assert_allclose(idx["loss"], host["loss"], rtol=1e-6)
        torch.testing.assert_close(idx["pred"], host["pred"], rtol=1e-6, atol=1e-7)
        _assert_weights_close(idx["weights"], host["weights"], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(idx["running_mean"], host["running_mean"], rtol=1e-6, atol=0)


def _batch():
    data = synthetic_age_dataset(n=64, img_size=16, seed=3)
    return {k: v[ranks.INDEXED_IDX] for k, v in data.items()}


def test_clipping_on_dp_equals_one_process(trainer_runs):
    """Global-norm clipping at the STS-B recipe's 5.0 sees the global
    gradient: the DP step equals the one-process step (SGD, so the update
    is the clipped gradient times the lr), and the clip took effect."""
    weights = trainer_runs["weights"]
    big = {**_batch(), "target": _batch()["target"] * 50.0}
    kw = dict(fds_config=None, optimizer="sgd", lr=0.1)
    one = ranks.one_step(ranks.tiny_trainer(None, clip_grad_norm=5.0, **kw), weights, big)
    unclipped = ranks.one_step(ranks.tiny_trainer(None, **kw), weights, big)
    moved = lambda r: max((r["weights"]["head"][k] - weights["head"][k]).abs().max()  # noqa: E731
                          for k in weights["head"])
    assert moved(unclipped) > 10 * moved(one)
    dp_loss = np.mean([r["clipped"]["loss"] for r in trainer_runs["dp"]])
    np.testing.assert_allclose(dp_loss, one["loss"], rtol=1e-5)
    _assert_weights_close(trainer_runs["dp"][0]["clipped"]["weights"], one["weights"],
                          rtol=1e-4, atol=1e-5)


def test_rrt_on_dp(trainer_runs):
    """RRT stage 2 under DP: the frozen backbone's weights bit-identical to
    where they started, the head as in one process (and moved)."""
    weights = trainer_runs["weights"]
    one = ranks.one_step(ranks.tiny_trainer(None, retrain_fc=True), weights, _batch())
    for r in trainer_runs["dp"]:
        got = r["rrt"]["weights"]
        for k, v in weights["backbone"].items():
            if "running" not in k:
                assert torch.equal(got["backbone"][k], v), k
        for k, v in one["weights"]["head"].items():
            torch.testing.assert_close(got["head"][k], v, rtol=1e-4, atol=1e-5)
        assert any(not torch.equal(got["head"][k], v) for k, v in weights["head"].items())


def test_remat_on_dp_is_bit_equal(trainer_runs):
    """Both remat modes recompute their blocks' batch norms, collectives
    and all, in the backward: the step is bit-equal to the plain one."""
    for r in trainer_runs["dp"]:
        plain = r["remat"][None]
        for mode in ("block", "conv_outs"):
            assert r["remat"][mode]["loss"] == plain["loss"]
            for part in ("backbone", "head"):
                for k, v in plain["weights"][part].items():
                    assert torch.equal(r["remat"][mode]["weights"][part][k], v), (mode, k)


def test_dryrun_multichip_on_cpu_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = dryrun_multichip(2, "cpu", timeout_s=SPAWN_TIMEOUT_S)
    for family in ("age", "stsb", "nyud2"):
        assert np.isfinite(out[family]["loss"]) and np.isfinite(out[family]["rrt_loss"])
        assert out["ranks"][0][family]["digest"] == out["ranks"][1][family]["digest"]
    # on the CPU every wrapper takes its plain version
    assert all(n == 0 for r in out["ranks"] for n in r["launches"].values())
    assert out["collectives"]["calls"] > 0


# ------------------------------------------------------------------ drivers


def _age_config(root, **kw):
    """The resume tests' tiny age run: 128 synthetic 16x16 images, 89 train
    (5 steps of 16), FDS + LDS, checkpoints."""
    base = dict(device="cpu", dataset="synthetic", synthetic_size=128, img_size=16, batch_size=16,
                epoch=1, lr=1e-3, loss="mse", store_root=str(root), fds=True, bucket_num=121,
                lds=True, reweight="sqrt_inv")
    return ExperimentConfig(**{**base, **kw})


TINY_AGE = {"BACKBONES": {"resnet50": (ranks.tiny_resnet, 8)}}


def test_age_driver_on_two_ranks(tmp_path, monkeypatch):
    """A one-process checkpoint (epoch 0) resumed on two ranks for epoch 1,
    against the one-process resume: equal losses and metrics within 1e-4,
    FDS counts exact; ranks bit-identical; rank 0 alone wrote the
    checkpoints, and the DP run's best loads into a one-process state bit
    for bit. With ``--max_steps_per_run -1``."""
    monkeypatch.setitem(age.BACKBONES, "resnet50", (ranks.tiny_resnet, 8))
    stage0 = _age_config(tmp_path / "stage0")
    age.run(stage0)
    store0 = f"{stage0.store_root}/{stage0.derived_store_name()}"
    one = age.run(_age_config(tmp_path / "one", epoch=2, resume=store0))
    dp_config = _age_config(tmp_path / "dp", epoch=2, resume=store0, num_devices=2,
                            max_steps_per_run=-1, ckpt_every_steps=2)
    dp = spawn(ranks.driver_rank, "age", dp_config, TINY_AGE)
    assert [h["epoch"] for h in dp[0]["history"]] == [1]
    np.testing.assert_allclose(dp[0]["history"][0]["train_loss"], one["history"][0]["train_loss"],
                               rtol=1e-4)
    for key in ("mse", "l1", "gmean"):
        np.testing.assert_allclose(dp[0]["test"][key], one["test"][key], rtol=1e-4)
    assert torch.equal(dp[0]["final_fds"].num_samples_tracked, one["final_fds"].num_samples_tracked)
    assert dp[0]["rank"]["digest"] == dp[1]["rank"]["digest"]
    assert dp[0]["writes"] and not dp[1]["writes"]
    dp_store = f"{dp_config.store_root}/{dp_config.derived_store_name()}"
    assert has_checkpoint(dp_store, "best") and has_checkpoint(dp_store, "latest")
    state = age.build_trainer(dataclasses.replace(dp_config, num_devices=None)).init_state(5)
    state, epoch, _ = restore_checkpoint(dp_store, state, which="best")
    assert state_digest(state) == dp[0]["best_state_digest"] == dp[1]["best_state_digest"]


def test_nyud2_driver_on_two_ranks(tmp_path):
    config = nyud2.NYUDConfig(device="cpu", synthetic_size=20, batch_size=4, test_batch_size=4,
                              epoch=1, store_root=str(tmp_path), lds=True, reweight="inverse",
                              fds=True, stage_sizes=(1, 1, 1, 1), width=8, lr=1e-3,
                              num_devices=2)
    dp = spawn(ranks.driver_rank, "nyud2", config, {"IMG_HW": (64, 96), "DEPTH_HW": (32, 48)})
    assert dp[0]["rank"]["digest"] == dp[1]["rank"]["digest"]
    assert dp[0]["writes"] and not dp[1]["writes"]
    assert np.isfinite(dp[0]["best_rmse"]) and dp[0]["best_rmse"] == dp[1]["best_rmse"]
    assert all(np.isfinite(h["train_loss"]) for h in dp[0]["history"])


def test_stsb_driver_starts_its_own_ranks(tmp_path):
    """``main`` with ``--num_devices 2`` and no process group starts two
    local ranks and returns rank 0's result with both ranks' reports; the
    ranks end bit-identical, and the best checkpoint loads into a
    one-process state bit for bit."""
    data_dir = tmp_path / "data"
    write_tiny_tsvs(str(data_dir), n_train=40, n_eval=10)
    argv = ["--data_dir", str(data_dir), "--device", "cpu", "--d_word", "8", "--d_hid", "8",
            "--n_layers_enc", "1", "--max_seq_len", "10", "--batch_size", "8",
            "--val_interval", "3", "--max_vals", "3", "--lr", "1e-2", "--glove", "0", "--fds",
            "--lds", "--reweight", "inverse", "--store_root", str(tmp_path / "runs"),
            "--cache_dir", str(tmp_path / "cache"), "--num_devices", "2",
            "--max_steps_per_run", "-1"]
    result = stsb.main(argv)
    assert len(result["ranks"]) == 2
    assert result["ranks"][0]["digest"] == result["ranks"][1]["digest"]
    assert result["iterations"] == 9 and len(result["val_history"]) == 3
    config = stsb.parse_sts_config(argv)
    store = f"{config.store_root}/{config.derived_store_name()}"
    train, _, _, emb, vocab = load_stsb_datasets(str(data_dir), config)
    trainer = stsb.build_sts_trainer(dataclasses.replace(config, num_devices=None), len(vocab), emb)
    state, _, _ = restore_checkpoint(store, trainer.init_state(3), which="best")
    assert state_digest(state, result["final_fds"]) == result["ranks"][0]["digest"]


@pytest.mark.parametrize("driver", ["age", "nyud2", "stsb"])
def test_batch_the_ranks_cannot_split_is_refused(tmp_path, driver):
    argv = ["--device", "cpu", "--num_devices", "2", "--batch_size", "7",
            "--store_root", str(tmp_path)]
    module = {"age": age, "nyud2": nyud2, "stsb": stsb}[driver]
    with pytest.raises(ValueError, match="does not divide over --num_devices 2"):
        module.main(argv)


@pytest.mark.parametrize("driver", ["age", "nyud2", "stsb"])
@pytest.mark.parametrize("value", [-1, 0])
def test_max_steps_per_run_opt_out_is_accepted(driver, value):
    """JAX's ``--max_steps_per_run -1`` (no recycling) and 0 run as the port
    always does; a positive value stays refused (the drivers' own tests)."""
    config = {"age": ExperimentConfig, "nyud2": nyud2.NYUDConfig, "stsb": stsb.STSConfig}[driver]
    module = {"age": age, "nyud2": nyud2, "stsb": stsb}[driver]
    module.check_supported(config(device="cpu", max_steps_per_run=value))
    with pytest.raises(NotImplementedError, match="max_steps_per_run"):
        module.check_supported(config(device="cpu", max_steps_per_run=5))
