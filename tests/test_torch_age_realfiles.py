"""The port's age driver on real image files, on the CPU: a meta CSV and
~200 tiny JPEGs whose pattern encodes the age (as the JAX package's
``tests/test_task_age_realfiles.py`` writes them), a tiny ResNet patched into
``age.BACKBONES``. The run gives the same losses and test metrics in ram,
mmap and stream mode; a stream-mode run killed after a mid-epoch save and
resumed is bit-equal to the uninterrupted one and never decodes the batches
it skips; ``build_data`` equals the JAX driver's on the same corpus."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from imbalanced_regression_tpu.tasks import age as jax_age
from imbalanced_regression_tpu.utils.config import ExperimentConfig as JaxConfig
from imbalanced_regression_tpu_torch.data import native_loader
from imbalanced_regression_tpu_torch.models.resnet import ResNetBasicBackbone
from imbalanced_regression_tpu_torch.tasks import age
from imbalanced_regression_tpu_torch.utils.checkpoint import read_checkpoint
from imbalanced_regression_tpu_torch.utils.config import ExperimentConfig


def _tiny_resnet(dtype, remat=None):
    return ResNetBasicBackbone(stage_sizes=(1,), width=8, dtype=torch.float32, remat=remat)


@pytest.fixture(autouse=True)
def _tiny_model_few_threads(monkeypatch):
    """The tiny model, and two intra-op threads (the suite runs in several
    worker processes at once; bit-equality needs one thread count)."""
    monkeypatch.setitem(age.BACKBONES, "resnet50", (_tiny_resnet, 8))
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """200 32x32 JPEGs and ``agedb.csv``: an imbalanced train split (150 of
    the ages in 25-34), balanced val and test splits of 20 each."""
    root = tmp_path_factory.mktemp("agedb")
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    ages = np.concatenate([rng.integers(25, 35, 150), rng.integers(0, 100, 50)])
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    rows = []
    for i, a in enumerate(ages):
        img = (np.sin((a / 100 * 3 + 0.5) * np.pi * (yy + xx)) * 100 + 128)[..., None]
        img = np.repeat(img, 3, -1) + rng.normal(0, 10, (32, 32, 3))
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(root / f"imgs/{i}.jpg", quality=90)
        split = "train" if i % 5 else ("val" if i % 10 else "test")
        rows.append(f"{a},imgs/{i}.jpg,{split}")
    (root / "agedb.csv").write_text("age,path,split\n" + "\n".join(rows) + "\n")
    return str(root)


def _config(corpus, root, **kw):
    """160 train images: 10 steps of 16 an epoch, two epochs, LDS + FDS."""
    base = dict(device="cpu", dataset="agedb", data_dir=corpus, img_size=32, batch_size=16,
                epoch=2, lr=1e-3, loss="l1", reweight="sqrt_inv", lds=True, fds=True,
                store_root=str(root), save_ckpt=0, workers=2, cache_dir=str(root / "cache"))
    return ExperimentConfig(**{**base, **kw})


def _outcome(result):
    return ([h["train_loss"] for h in result["history"]],
            [h["val_loss_l1"] for h in result["history"]], result["test"], result["best_loss"])


@pytest.fixture(scope="module")
def ram_run(corpus, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(age.BACKBONES, "resnet50", (_tiny_resnet, 8))
        before = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            return age.run(_config(corpus, tmp_path_factory.mktemp("ram"), data_mode="ram"))
        finally:
            torch.set_num_threads(before)


@pytest.mark.parametrize("mode", ["ram", "mmap", "stream"])
def test_driver_trains_on_real_files_in_every_mode(corpus, ram_run, tmp_path, mode):
    result = age.run(_config(corpus, tmp_path, data_mode=mode))
    losses, val, test, best = _outcome(result)
    assert all(np.isfinite(losses)) and np.isfinite(test["l1"]) and test["l1"] < 60
    assert set(result["shots"]) == {"many", "median", "low"}
    assert _outcome(result) == _outcome(ram_run)
    assert (tmp_path / "cache").exists() == (mode == "mmap")


def test_stream_resume_skips_batches_undecoded(corpus, tmp_path, monkeypatch):
    """Killed right after its second mid-epoch save (epoch 0, step 4) and
    resumed in stream mode: test metrics and checkpoints bit-equal to the
    uninterrupted run's, and the resumed run decodes exactly what the
    uninterrupted one decodes after its first four train batches."""
    calls = []
    real_decode = native_loader.decode_resize_batch

    def counting(paths, *a, **kw):
        calls.append(tuple(paths))
        return real_decode(paths, *a, **kw)

    monkeypatch.setattr(native_loader, "decode_resize_batch", counting)
    kw = dict(data_mode="stream", save_ckpt=1, ckpt_every_steps=2)
    full_cfg = _config(corpus, tmp_path / "full", **kw)
    full = age.run(full_cfg)
    full_calls, calls[:] = list(calls), []

    cfg = _config(corpus, tmp_path / "resumed", **kw)
    store = f"{cfg.store_root}/{cfg.derived_store_name()}"
    real_save, saves = age.save_checkpoint, []

    def dying_save(*args, **kwargs):
        real_save(*args, **kwargs)
        saves.append(1)
        if len(saves) == 2:
            raise RuntimeError("killed after a mid-epoch checkpoint")

    monkeypatch.setattr(age, "save_checkpoint", dying_save)
    with pytest.raises(RuntimeError, match="killed after"):
        age.run(cfg)
    monkeypatch.setattr(age, "save_checkpoint", real_save)
    calls[:] = []
    resumed = age.run(dataclasses.replace(cfg, resume=store))
    assert calls == full_calls[4:]
    assert resumed["test"] == full["test"] and resumed["best_loss"] == full["best_loss"]
    full_store = f"{full_cfg.store_root}/{full_cfg.derived_store_name()}"
    for which in ("latest", "best"):
        a, b = read_checkpoint(full_store, which), read_checkpoint(store, which)
        for part in ("backbone", "head"):
            for k, v in a[part].items():
                assert torch.equal(b[part][k], v), (which, part, k)


def test_build_data_matches_jax(corpus):
    kw = dict(dataset="agedb", data_dir=corpus, img_size=32, workers=2, data_mode="ram",
              reweight="inverse", lds=True)
    got = age.build_data(ExperimentConfig(**kw))
    want = jax_age.build_data(JaxConfig(**kw))
    for g, w in zip(got[:3], want[:3]):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert np.array_equal(got[3], want[3])
