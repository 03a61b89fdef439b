"""The port's Trainer held against the JAX Trainer on the CPU: one train step
and one FDS stats pass from the same weights (converted from Flax), the same
non-trivial FDS state and the same batches, with augmentation off. Also: the
port never imports jax, and its entry points refuse to run on the CPU unless
asked."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
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
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig, resolve_device

REPO = Path(__file__).resolve().parents[1]
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
    arrays = {
        "epoch": np.asarray(1, np.int32),
        "running_mean": rng.normal(size=(b, d)).astype(np.float32),
        "running_var": rng.uniform(0.2, 2.0, size=(b, d)).astype(np.float32),
        "running_mean_last_epoch": rng.normal(size=(b, d)).astype(np.float32) * 0.3,
        "running_var_last_epoch": rng.uniform(0.2, 2.0, size=(b, d)).astype(np.float32),
        "smoothed_mean_last_epoch": rng.normal(size=(b, d)).astype(np.float32) * 0.3,
        "smoothed_var_last_epoch": rng.uniform(0.2, 2.0, size=(b, d)).astype(np.float32),
        "num_samples_tracked": rng.integers(0, 50, size=b).astype(np.float32),
    }
    return arrays


def _vars_np(jstate):
    return jax.tree.map(np.asarray, {"params": jstate.params["backbone"],
                                     "batch_stats": jstate.batch_stats})


def test_train_step_and_fds_pass_match_jax(rng):
    data = synthetic_age_dataset(n=64, img_size=16, seed=3)
    data["weight"] = prepare_weights_age(data["target"].reshape(-1), "sqrt_inv", lds=True)[:, None]
    batches = [{k: v[i * 32:(i + 1) * 32] for k, v in data.items()} for i in range(2)]
    jfds_cfg = JFDSConfig.for_age(feature_dim=64, bucket_num=121)
    tfds_cfg = FDSConfig.for_age(feature_dim=64, bucket_num=121)

    jtrainer = JTrainer(JBackbone(stage_sizes=(1, 1), width=8, dtype=jnp.float32), JHead(),
                        JTrainerConfig(loss="l1", lr=1e-3), fds_config=jfds_cfg, mesh=create_mesh(1))
    jstate = jtrainer.init_state(jax.random.key(0), data["input"][:2])
    fds_np = _random_fds(rng, 121, 64)
    jstate = jstate.replace(fds=jstate.fds.replace(**{k: jnp.asarray(v) for k, v in fds_np.items()}))

    trainer = Trainer(ResNetBackbone(stage_sizes=(1, 1), width=8, dtype=torch.float32),
                      RegressionHead(64), TrainerConfig(loss="l1", lr=1e-3), fds_config=tfds_cfg,
                      device="cpu")
    state = trainer.init_state(0)
    sd = from_flax(_vars_np(jstate), jax.tree.map(np.asarray, jstate.params["head"]))
    state.backbone.load_state_dict(sd["backbone"])
    state.head.load_state_dict(sd["head"])
    state.fds = fds_state_from_numpy(fds_np, device="cpu")

    # one train step at epoch 2 (calibration on, lr 1e-3)
    jstate, jloss, jpred = jtrainer.train_step(jstate, batches[0], 2)
    state, loss, pred = trainer.train_step(state, batches[0], 2)
    # float32 forward on both sides, reductions in another order: 1e-5
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    want = from_flax(_vars_np(jstate), jax.tree.map(np.asarray, jstate.params["head"]))
    got = {**{f"backbone.{k}": v for k, v in state.backbone.state_dict().items()},
           **{f"head.{k}": v for k, v in state.head.state_dict().items()}}
    # Adam's first step moves each weight by about lr * sign(grad) = 1e-3;
    # gradients agree to float32 rounding, so the updated weights agree to a
    # small fraction of one step (2e-5 = 2% of lr)
    for part in ("backbone", "head"):
        for k, v in want[part].items():
            np.testing.assert_allclose(got[f"{part}.{k}"].numpy(), v.numpy(), rtol=0, atol=2e-5,
                                       err_msg=f"{part}.{k}")

    # FDS stats pass at epoch 2: snapshot (state epoch 1 → 2), then update
    jstate = jtrainer.fds_epoch_pass(jstate, batches, 2)
    state = trainer.fds_epoch_pass(state, batches, 2)
    assert state.fds.epoch == int(jstate.fds.epoch) == 2
    for f in FDS_FIELDS:
        # moments of encodings that differ by float32 rounding: 1e-4
        np.testing.assert_allclose(getattr(state.fds, f).numpy(), np.asarray(getattr(jstate.fds, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    want_bn = from_flax(_vars_np(jstate))["backbone"]
    got_bn = state.backbone.state_dict()
    for k, v in want_bn.items():
        if "running" in k:
            np.testing.assert_allclose(got_bn[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def test_predict_pads_and_trims(rng):
    data = synthetic_age_dataset(n=40, img_size=16, seed=1)
    trainer = Trainer(ResNetBackbone(stage_sizes=(1,), width=8, dtype=torch.float32),
                      RegressionHead(32), TrainerConfig(loss="mse"), device="cpu")
    state = trainer.init_state(0)
    from imbalanced_regression_tpu_torch.data.batching import eval_batches

    preds, targets = trainer.predict(state, eval_batches(data, 16))  # 40 % 16 != 0
    assert preds.shape == (40, 1)
    np.testing.assert_array_equal(targets, data["target"])
    state, loss = trainer.train_epoch(state, [{k: v[:16] for k, v in data.items()}], 0)
    assert np.isfinite(loss) and state.step == 1


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(device)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ResNetBackbone(stage_sizes=(1,), width=8), RegressionHead(32), TrainerConfig())


def test_port_never_imports_jax():
    """Every module of the port imports with jax (and NLTK, pandas and PIL,
    which the H100 machine lacks) nowhere in sys.modules: the age CSV is read
    with the ``csv`` module, and PIL is imported only inside the reject path
    of ``decode_resize_batch`` and the NYUD2 real-data loader."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "imbalanced_regression_tpu_torch").rglob("*.py"))
    assert len(modules) >= 27
    assert {"imbalanced_regression_tpu_torch.utils.checkpoint",
            "imbalanced_regression_tpu_torch.utils.meters",
            "imbalanced_regression_tpu_torch.data.age",
            "imbalanced_regression_tpu_torch.data.native_loader",
            "imbalanced_regression_tpu_torch.data.staging",
            "imbalanced_regression_tpu_torch.data.streaming"} <= set(modules)
    code = ("import importlib, sys\n"
            "sys.argv[1:] = ['--device', 'cpu']  # the tutorial script runs on import\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', "
            "'optax', 'orbax', 'nltk', 'pandas', 'PIL', 'imbalanced_regression_tpu.')) "
            "or m == 'imbalanced_regression_tpu')\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
