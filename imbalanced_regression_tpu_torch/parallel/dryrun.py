"""A data-parallel dry run of every task family on ``n`` local ranks.

The port's counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``: per family, at its tiny widths,
one DP train step with FDS calibrating (``start_smooth=0``), one
stats-pass step (moments all-reduced over the ranks), a padded eval batch
(the padding a multiple of the rank count) and an RRT stage-2 step
(backbone bit-identical, head moved):

- age: integer buckets, image augmentation, a 16-d encoding;
- STS-B: nested token inputs, histogram buckets, dropout, grad clipping,
  targets / 5;
- NYUD2: per-pixel FDS, photometric augmentation, per-pixel LDS weights.

``dryrun_multichip(2, "cpu")`` runs it on the CPU. The ranks use gloo, so
on one card they share it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from imbalanced_regression_tpu_torch.data.batching import batch_iterator, eval_batches, tree_map
from imbalanced_regression_tpu_torch.data.nyud2 import (
    TRAIN_BUCKET_NUM,
    imagenet_normalize,
    make_pixel_weight_fn,
    nyud2_train_photometric,
    synthetic_depth_dataset,
)
from imbalanced_regression_tpu_torch.data.synthetic import synthetic_age_dataset
from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.models.bilstm_pair import PairBiLSTMEncoder
from imbalanced_regression_tpu_torch.models.depth_encdec import (
    DepthEncoderDecoder,
    DepthHead,
    depth_feature_dim,
)
from imbalanced_regression_tpu_torch.models.resnet import RegressionHead, ResNetBasicBackbone
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.ops.binning import bin_index_hist_np
from imbalanced_regression_tpu_torch.ops.lds import prepare_weights_depth
from imbalanced_regression_tpu_torch.parallel.launch import run_ranks, state_digest
from imbalanced_regression_tpu_torch.parallel.mesh import create_mesh
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig


def _drive(build: Callable[[bool], Trainer], data: dict, batch_size: int, n_devices: int,
           per_sample: bool) -> dict:
    """The four checks on one family (``build(retrain_fc)`` makes its
    trainer on fresh modules); returns its loss, the RRT loss, the digest
    of the trained state and the seconds the checks took."""
    t0 = time.perf_counter()
    trainer = build(False)
    state = trainer.init_state(0)
    batches = lambda: batch_iterator(data, batch_size, shuffle=False)  # noqa: E731
    # one DP train step at epoch 1 >= start_smooth: FDS calibrates
    state, loss = trainer.train_epoch(state, batches(), epoch=1)
    # one stats-pass step: the moments all-reduced over the ranks
    state = trainer.fds_epoch_pass(state, batches(), epoch=1)
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")
    if per_sample:  # dense (NYUD2) counts are per pixel
        tracked = float(state.fds.num_samples_tracked.sum())
        if tracked != batch_size:
            raise AssertionError(f"FDS tracked {tracked} samples, the global batch has {batch_size}")

    # padded eval: a short final batch padded to batch_size (a multiple of
    # the ranks) and trimmed to its count, every rank holding all rows
    n_eval = batch_size - n_devices
    eval_data = tree_map(lambda v: v[:n_eval],
                         {k: v for k, v in data.items() if k in ("input", "target")})
    batch = next(eval_batches(eval_data, batch_size))
    count = batch.pop("count")
    preds = trainer.predict_batch(state, batch, count)
    if preds.shape[0] != n_eval or not np.all(np.isfinite(preds)):
        raise AssertionError(f"padded eval gave {preds.shape} rows, finite {np.isfinite(preds).all()}")

    # RRT stage 2 under the same mesh: the stage-1 backbone grafted in, the
    # backbone frozen, the head trained
    rrt = build(True)
    stage1 = {k: v.clone() for k, v in state.backbone.state_dict().items()}
    rstate = rrt.init_state(1)
    rstate.backbone.load_state_dict(stage1)
    rstate.fds = state.fds
    head_before = [p.detach().clone() for p in rstate.head.parameters()]
    rstate, rloss, _ = rrt.train_step(rstate, next(batches()), epoch=1)
    for k, v in rstate.backbone.state_dict().items():
        if "running" not in k and not torch.equal(v, stage1[k]):
            raise AssertionError(f"RRT moved the frozen backbone's {k}")
    if not any(not torch.equal(a, b) for a, b in zip(head_before, rstate.head.parameters())):
        raise AssertionError("RRT left the head as it was")
    if not np.isfinite(float(rloss)):
        raise FloatingPointError(f"non-finite RRT loss {float(rloss)}")
    return {"loss": loss, "rrt_loss": float(rloss), "digest": state_digest(state),
            "seconds": time.perf_counter() - t0}


def dryrun_rank(n_devices: int, device: str) -> dict:
    """The three families' checks on this rank of ``n_devices`` gloo ranks
    (in a process group that is up: a rank of ``run_ranks``); raises if
    one fails. Returns each family's loss, RRT loss, digest and seconds,
    and this rank's kernel launches and collectives."""
    t0 = time.perf_counter()
    mesh = create_mesh(n_devices, backend="gloo", device=device)
    batch_size = 4 * n_devices
    out = {}

    def age(retrain_fc: bool) -> Trainer:
        return Trainer(ResNetBasicBackbone(stage_sizes=(1, 1), width=8, dtype=torch.float32),
                       RegressionHead(16), TrainerConfig(loss="l1", lr=1e-3, retrain_fc=retrain_fc),
                       fds_config=FDSConfig.for_age(feature_dim=16, bucket_num=121,
                                                    start_smooth=0),
                       mesh=mesh)

    out["age"] = _drive(age, synthetic_age_dataset(n=batch_size, img_size=16, seed=0),
                        batch_size, n_devices, per_sample=True)

    d_hid = 4

    def sts(retrain_fc: bool) -> Trainer:
        return Trainer(PairBiLSTMEncoder(vocab_size=50, d_word=8, d_hid=d_hid, n_layers=1,
                                         n_highway=0, dropout=0.2, dropout_embs=0.2,
                                         train_words=True, dtype=torch.float32),
                       RegressionHead(8 * d_hid),
                       TrainerConfig(loss="mse", lr=1e-4, clip_grad_norm=5.0, target_scale=5.0,
                                     schedule=(), retrain_fc=retrain_fc),
                       fds_config=FDSConfig.for_sts(feature_dim=8 * d_hid, bucket_num=50,
                                                    start_update=0, start_smooth=0),
                       mesh=mesh)

    r = np.random.default_rng(1)
    length = 12
    tokens = {
        "tokens1": r.integers(1, 50, size=(batch_size, length)).astype(np.int32),
        "mask1": (np.arange(length)[None, :] < r.integers(3, length, size=(batch_size, 1)))
        .astype(np.float32),
        "tokens2": r.integers(1, 50, size=(batch_size, length)).astype(np.int32),
        "mask2": (np.arange(length)[None, :] < r.integers(3, length, size=(batch_size, 1)))
        .astype(np.float32),
    }
    targets = (r.random((batch_size, 1)) * 5).astype(np.float32)
    sts_data = {"input": tokens, "target": targets, "weight": np.ones((batch_size, 1), np.float32),
                "bucket_idx": bin_index_hist_np(targets.reshape(-1), 50, 0)}
    out["stsb"] = _drive(sts, sts_data, batch_size, n_devices, per_sample=True)

    width = 8
    bucket_weights = prepare_weights_depth(TRAIN_BUCKET_NUM, "inverse", bucket_num=100,
                                           bucket_start=7, lds=True, lds_kernel="gaussian",
                                           lds_ks=5, lds_sigma=2.0)
    feat = depth_feature_dim(num_features=width * 32)

    def nyud(retrain_fc: bool) -> Trainer:
        return Trainer(DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=width,
                                           dtype=torch.float32),
                       DepthHead(feat), TrainerConfig(loss="mse", lr=1e-4, adam_weight_decay=1e-4,
                                                      schedule=(), retrain_fc=retrain_fc),
                       fds_config=FDSConfig.for_depth(feature_dim=feat, bucket_num=100,
                                                      bucket_start=7, start_update=0,
                                                      start_smooth=0),
                       train_augment=nyud2_train_photometric, eval_transform=imagenet_normalize,
                       weight_fn=make_pixel_weight_fn(bucket_weights), mesh=mesh)

    out["nyud2"] = _drive(nyud, synthetic_depth_dataset(batch_size, img_hw=(32, 32),
                                                        depth_hw=(16, 16)),
                          batch_size, n_devices, per_sample=False)
    out["launches"] = {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}
    out["seconds"] = time.perf_counter() - t0
    out["collectives"] = dataclasses.asdict(mesh.stats)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout_s: float | None = 600.0) -> dict:
    """Run the three families' DP checks on ``n_devices`` gloo ranks (on
    ``device``; CUDA ranks share the cards round-robin). Raises if a check
    fails on any rank or the ranks end with different states. Returns rank
    0's results with every rank's under ``"ranks"``."""
    return check_ranks(run_ranks(dryrun_rank, n_devices, n_devices, device, backend="gloo",
                                 timeout_s=timeout_s))


def check_ranks(results: list[dict]) -> dict:
    """Raise unless every rank's :func:`dryrun_rank` ended with the same
    state in each family; returns rank 0's results with every rank's under
    ``"ranks"``."""
    for family in ("age", "stsb", "nyud2"):
        digests = {r[family]["digest"] for r in results}
        if len(digests) != 1:
            raise AssertionError(f"{family}: the ranks ended with {len(digests)} different states")
    return {**results[0], "ranks": results}

