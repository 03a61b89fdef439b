"""Smoke run of the port's age driver (``tasks/age.py``) on the CPU: ResNet-50
in bf16 with LDS and FDS, two epochs on synthetic 32x32 images, asked for with
``--device cpu``. (At 16x16 the last two stages of ResNet-50 run on 1x1 maps,
where the CPU's bf16 convolutions give non-finite gradients even with
PyTorch's own batch norm; at 32x32 only the last stage does, and training
stays finite.)"""

import math

import numpy as np
import pytest
import torch

from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.tasks import age


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _argv(tmp_path, *extra):
    return ["--device", "cpu", "--synthetic_size", "96", "--img_size", "32", "--batch_size", "16",
            "--epoch", "2", "--fds", "--lds", "--reweight", "sqrt_inv", "--save_ckpt", "0",
            "--store_root", str(tmp_path), *extra]


def test_age_driver_two_epochs_on_cpu(tmp_path):
    ck.reset_launch_counts()
    result = age.main(_argv(tmp_path))
    history = result["history"]
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(math.isfinite(h["train_loss"]) for h in history)
    assert all(math.isfinite(v) for v in result["test"].values())
    assert set(result["shots"]) == {"many", "median", "low"}
    # epoch 1 smooths with the snapshot the epoch-1 pass has not taken yet:
    # the fds_init identity (start_update=0, start_smooth=1)
    assert not history[1]["fds_calibrating"]
    fds = result["final_fds"]
    assert fds.epoch == 1 and float(fds.num_samples_tracked.sum()) > 0
    assert np.abs(fds.running_mean_last_epoch.numpy()).sum() > 0
    # on the CPU every wrapper takes its plain version: no launches
    assert all(fn.launches == 0 for fn in ck.KERNEL_WRAPPERS)
    assert (tmp_path / "imdb_wiki_resnet50_lds_gau_5_1.0_fds_gau_5_1.0_0_1_0.9_adam_l1_0.001_16"
            / "metrics.jsonl").exists()


@pytest.mark.parametrize("flag", [["--max_steps_per_run", "5"], ["--num_devices", "2"],
                                  ["--synthetic_size", "0"]])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        age.main(_argv(tmp_path, *flag))


def test_default_device_is_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        age.main(argv)
