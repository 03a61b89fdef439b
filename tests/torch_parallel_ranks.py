"""Rank functions of ``tests/test_torch_parallel.py`` and the card tests of
``tests/test_torch_cuda.py``: each runs on every rank of
``parallel.launch.run_ranks`` and returns what the test holds against one
process. They import torch, numpy and the port only (each rank is a fresh
process), and build their inputs from seeds, so the test rebuilds the same
ones."""

import dataclasses

import numpy as np
import torch

from imbalanced_regression_tpu_torch.data.augment import random_crop_flip_normalize
from imbalanced_regression_tpu_torch.data.batching import batch_iterator
from imbalanced_regression_tpu_torch.data.nyud2 import nyud2_train_photometric
from imbalanced_regression_tpu_torch.data.synthetic import synthetic_age_dataset
from imbalanced_regression_tpu_torch.fds import FDSConfig, fds_bucket_moments, fds_smooth
from imbalanced_regression_tpu_torch.models.bilstm_pair import dropout
from imbalanced_regression_tpu_torch.models.resnet import (
    BatchNorm,
    RegressionHead,
    ResNetBackbone,
    ResNetBasicBackbone,
)
from imbalanced_regression_tpu_torch.ops.moments import all_reduce_moments
from imbalanced_regression_tpu_torch.parallel import launch
from imbalanced_regression_tpu_torch.parallel.mesh import create_mesh, replicate, shard_batch
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig

WORLD = 2


def rows(rank: int, n: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``n``."""
    k = n // WORLD
    return slice(rank * k, (rank + 1) * k)


# ---------------------------------------------------------------- inputs


def bn_inputs():
    """A float32 NCHW batch of 8, its BN weight and bias, and the loss
    weights R of ``(out * R).sum()``."""
    r = np.random.default_rng(0)
    x = r.normal(2.0, 3.0, size=(8, 4, 5, 5)).astype(np.float32)
    w = r.uniform(0.5, 1.5, size=4).astype(np.float32)
    b = r.normal(size=4).astype(np.float32)
    weights = r.normal(size=(8, 4, 5, 5)).astype(np.float32)
    return x, w, b, weights


def age_moments_inputs():
    """64 rows of 32 features with integer labels in [1, 18]; the low edge
    label 0 only in rank 0's rows and the high edge label 19 only in rank
    1's (so each rank alone sees one edge), and labels past the high edge
    (pooled into its bucket) on both."""
    r = np.random.default_rng(1)
    feats = r.normal(size=(64, 32)).astype(np.float32)
    labels = r.integers(1, 19, size=64).astype(np.float32)
    labels[[3, 10]] = 0.0
    labels[[40, 50]] = 19.0
    labels[[5, 45]] = 22.0
    return FDSConfig(feature_dim=32, bucket_num=20, grouping="age"), feats, labels[:, None]


def depth_moments_inputs():
    r = np.random.default_rng(2)
    feats = r.normal(size=(16, 6, 6, 8)).astype(np.float32)
    depth = r.uniform(0, 3.2, size=(16, 6, 6, 1)).astype(np.float32)
    return FDSConfig.for_depth(feature_dim=8, bucket_num=30, bucket_start=4), feats, depth


def smooth_state(cfg, seed=3):
    """A non-trivial FDS snapshot for ``fds_smooth``."""
    from imbalanced_regression_tpu_torch.fds import fds_init

    r = np.random.default_rng(seed)
    b, d = cfg.num_buckets, cfg.feature_dim
    t = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    return fds_init(cfg, "cpu").replace(
        epoch=1,
        running_mean_last_epoch=t(r.normal(size=(b, d)) * 0.3),
        running_var_last_epoch=t(r.uniform(0.2, 2.0, size=(b, d))),
        smoothed_mean_last_epoch=t(r.normal(size=(b, d)) * 0.3),
        smoothed_var_last_epoch=t(r.uniform(0.2, 2.0, size=(b, d))))


def draw_inputs():
    """uint8 images [8, 12, 12, 3], encodings [8, 6] and a sentence pair's
    stacked hidden states [2 * 8, 5, 4]."""
    r = np.random.default_rng(4)
    images = r.integers(0, 256, size=(8, 12, 12, 3)).astype(np.uint8)
    enc = r.normal(size=(8, 6)).astype(np.float32)
    pair = r.normal(size=(16, 5, 4)).astype(np.float32)
    return images, enc, pair


def draws(images, enc, pair, generator):
    """The draws a DP step makes, in its order: augmentation, head
    dropout, the pair encoder's dropout (two stacked columns), NYUD2's
    photometric jitter."""
    head = RegressionHead(6, dropout=0.5)
    head.reset_parameters(torch.Generator().manual_seed(0))
    head.train()
    with torch.no_grad():
        return {
            "augment": random_crop_flip_normalize(images, generator, padding=4),
            "head": head(enc, generator=generator),
            "pair": dropout(pair, 0.3, generator, groups=2),
            "photometric": nyud2_train_photometric(images, generator),
        }


AGE_FDS = FDSConfig.for_age(feature_dim=16, bucket_num=121)


def tiny_trainer(mesh, device="cpu", fds_config=AGE_FDS, remat=None, **config):
    """test_parallel.py's model: ResNetBasicBackbone((1, 1), width 8),
    float32, mse, Adam 1e-3, FDS in the age grouping (16-d, 121 buckets)."""
    return Trainer(ResNetBasicBackbone(stage_sizes=(1, 1), width=8, dtype=torch.float32,
                                       remat=remat),
                   RegressionHead(16), TrainerConfig(**{"loss": "mse", "lr": 1e-3, **config}),
                   fds_config=fds_config, device=device, mesh=mesh)


def load_weights(state, weights):
    state.backbone.load_state_dict(weights["backbone"])
    state.head.load_state_dict(weights["head"])
    return state


def weights_of(state) -> dict:
    return {part: {k: v.detach().cpu().clone() for k, v in getattr(state, part).state_dict().items()}
            for part in ("backbone", "head")}


def two_epochs(trainer, weights, data):
    """test_parallel.py's run: two epochs of batch 32 (the same order in
    both), each followed by the FDS stats pass."""
    state = load_weights(trainer.init_state(0), weights)
    losses = []
    for epoch in range(2):
        state, loss = trainer.train_epoch(
            state, batch_iterator(data, 32, rng=np.random.default_rng(7)), epoch)
        state = trainer.fds_epoch_pass(
            state, batch_iterator(data, 32, rng=np.random.default_rng(7)), epoch)
        losses.append(loss)
    return {"losses": losses, "weights": weights_of(state),
            "running_mean": state.fds.running_mean.clone(),
            "num_samples_tracked": state.fds.num_samples_tracked.clone()}


INDEXED_IDX = np.asarray([3, 60, 11, 45, 27, 9, 54, 36, 1, 18, 63, 30, 7, 42, 21, 50], np.int64)


def one_step(trainer, weights, batch, epoch=1):
    state = load_weights(trainer.init_state(0), weights)
    state, loss, pred = trainer.train_step(state, batch, epoch)
    return {"loss": float(loss), "pred": pred.clone(), "weights": weights_of(state)}


# ---------------------------------------------------------------- ranks


def primitives_rank() -> dict:
    """shard_batch, create_mesh past the ranks, replicate, gather_rows,
    the global-batch BatchNorm, sharded moments and fds_smooth, and the
    sharded draws, on this rank."""
    torch.set_num_threads(1)
    mesh = create_mesh(WORLD, device="cpu")
    rank = mesh.rank
    out = {"rank": rank, "world_size": mesh.world_size, "backend": mesh.backend}

    out["shard"] = shard_batch(mesh, {"x": np.arange(24).reshape(8, 3),
                                      "nested": {"y": np.arange(8)}})
    try:
        shard_batch(mesh, {"x": np.arange(7)})
    except ValueError as e:
        out["odd_batch"] = str(e)
    try:
        create_mesh(WORLD + 1, device="cpu")
    except ValueError as e:
        out["too_many"] = str(e)

    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(rank + 1.0)
        module.bias.fill_(-(rank + 1.0))
    extra = torch.full((4,), float(rank))
    replicate(mesh, {"module": module, "extra": extra, "step": rank})
    out["replicated"] = (module.weight.detach().clone(), module.bias.detach().clone(), extra)
    out["gathered"] = mesh.gather_rows(torch.full((2, 3), float(rank)))
    out["mean"] = mesh.mean(torch.tensor([float(rank), 2.0 * rank]))

    x, w, b, weights = bn_inputs()
    bn = BatchNorm(4)
    bn.mesh = mesh
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(w))
        bn.bias.copy_(torch.as_tensor(b))
    xl = torch.as_tensor(x[rows(rank, 8)]).requires_grad_(True)
    y = bn(xl)
    (y * torch.as_tensor(weights[rows(rank, 8)])).sum().backward()
    out["bn"] = {"y": y.detach(), "dx": xl.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
                 "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}

    cfg, feats, labels = age_moments_inputs()
    local = fds_bucket_moments(cfg, torch.as_tensor(feats[rows(rank, 64)]),
                               torch.as_tensor(labels[rows(rank, 64)]))
    out["age_local_edges"] = (bool(local.has_lo), bool(local.has_hi))
    out["age_moments"] = dataclasses.asdict(all_reduce_moments(local, mesh))
    state = smooth_state(cfg)
    out["age_smooth"] = fds_smooth(cfg, state, torch.as_tensor(feats[rows(rank, 64)]),
                                   torch.as_tensor(labels[rows(rank, 64)]), epoch=1, mesh=mesh)
    cfg, feats, depth = depth_moments_inputs()
    local = fds_bucket_moments(cfg, torch.as_tensor(feats[rows(rank, 16)]),
                               torch.as_tensor(depth[rows(rank, 16)]))
    out["depth_moments"] = dataclasses.asdict(all_reduce_moments(local, mesh))

    images, enc, pair = draw_inputs()
    generator = torch.Generator().manual_seed(5)
    n = 8
    local_pair = np.concatenate([pair[:n][rows(rank, n)], pair[n:][rows(rank, n)]])
    out["draws"] = draws(torch.as_tensor(images[rows(rank, n)]),
                         torch.as_tensor(enc[rows(rank, n)]), torch.as_tensor(local_pair),
                         mesh.sharded(generator))
    out["generator_state"] = generator.get_state()
    return out


def trainer_rank(weights: dict) -> dict:
    """The tiny-ResNet Trainer on this rank of a 2-rank mesh: two epochs
    with the stats pass; an indexed step and stats pass against the same
    host batch; a clipped step; an RRT step; one step under each remat mode
    against the plain one."""
    torch.set_num_threads(1)
    mesh = create_mesh(WORLD, device="cpu")
    data = synthetic_age_dataset(n=64, img_size=16, seed=3)
    out = {"two_epochs": two_epochs(tiny_trainer(mesh), weights, data)}

    fds0 = FDSConfig.for_age(feature_dim=16, bucket_num=121, start_update=0, start_smooth=0)
    batch = {k: v[INDEXED_IDX] for k, v in data.items()}
    trainer = tiny_trainer(mesh, fds_config=fds0)
    state = load_weights(trainer.init_state(0), weights)
    state, loss, pred = trainer.train_step(state, batch, epoch=1)
    state = trainer.fds_epoch_pass(state, [batch], epoch=1)
    host = {"loss": float(loss), "pred": pred, "weights": weights_of(state),
            "running_mean": state.fds.running_mean.clone()}
    trainer = tiny_trainer(mesh, fds_config=fds0)
    state = load_weights(trainer.init_state(0), weights)
    trainer.bind_device_data(data)
    state, loss, pred = trainer.train_step_indexed(state, INDEXED_IDX, epoch=1)
    state = trainer.fds_epoch_pass_indexed(state, [INDEXED_IDX], epoch=1)
    out["indexed"] = {"host": host, "indexed": {
        "loss": float(loss), "pred": pred, "weights": weights_of(state),
        "running_mean": state.fds.running_mean.clone()}}

    big = {**batch, "target": batch["target"] * 50.0}
    out["clipped"] = one_step(tiny_trainer(mesh, fds_config=None, clip_grad_norm=5.0,
                                           optimizer="sgd", lr=0.1), weights, big)
    out["rrt"] = one_step(tiny_trainer(mesh, retrain_fc=True), weights, batch)
    out["remat"] = {remat: one_step(tiny_trainer(mesh, fds_config=None, remat=remat), weights,
                                    batch)
                    for remat in (None, "block", "conv_outs")}
    out["collectives"] = dataclasses.asdict(mesh.stats)
    return out


def driver_rank(task: str, config, patch: dict) -> dict:
    """A driver's ``run`` on this rank through ``run_driver`` (the process
    group is up: the run stays in this process), with ``patch``
    (module attribute → value) applied to the driver's module; counts
    the checkpoint writes of this rank."""
    import importlib

    from imbalanced_regression_tpu_torch.utils import checkpoint

    torch.set_num_threads(1)
    module = importlib.import_module(f"imbalanced_regression_tpu_torch.tasks.{task}")
    for name, value in patch.items():
        if isinstance(getattr(module, name), dict):
            getattr(module, name).update(value)
        else:
            setattr(module, name, value)
    writes = []
    real_save = checkpoint.torch.save
    checkpoint.torch.save = lambda obj, path: (writes.append(str(path)), real_save(obj, path))
    try:
        result = launch.run_driver(module.run, config)
    finally:
        checkpoint.torch.save = real_save
    return {**launch._to_host(result), "writes": writes,
            "best_state_digest": launch.state_digest(result["state"])}


def tiny_resnet(dtype, remat=None):
    """The resume tests' age model: one BasicBlock stage of width 8 (an
    8-d encoding), float32."""
    return ResNetBasicBackbone(stage_sizes=(1,), width=8, dtype=torch.float32, remat=remat)


# ---------------------------------------------------------------- the card


def resnet50_trainer(mesh, device):
    """ResNet-50 at full width in float32 with the age FDS (start_smooth 0,
    so K1/K2 run), L1 and SGD, for the card's one-step checks."""
    return Trainer(ResNetBackbone(dtype=torch.float32), RegressionHead(2048),
                   TrainerConfig(loss="l1", optimizer="sgd", lr=1e-3),
                   fds_config=FDSConfig.for_age(start_smooth=0),
                   train_augment=random_crop_flip_normalize, device=device, mesh=mesh)


def resnet50_step(mesh, device, n=32, img_size=224, perturb=0.0) -> dict:
    """One SGD step of :func:`resnet50_trainer` from seed 0 on ``n``
    synthetic images (scaled by ``1 + perturb``); the global loss, the
    weights before and after (BN buffers apart), the BN buffers and the
    digest."""
    trainer = resnet50_trainer(mesh, device)
    state = trainer.init_state(0)

    def tensors(running: bool) -> dict:
        return {f"{part}.{k}": v.detach().cpu().clone() for part in ("backbone", "head")
                for k, v in getattr(state, part).state_dict().items() if ("running" in k) == running}

    before = tensors(running=False)
    data = synthetic_age_dataset(n=n, img_size=img_size, seed=5)
    data["input"] = data["input"] * (1.0 + perturb)
    state, loss, _ = trainer.train_step(state, data, epoch=1)
    return {"loss": float(trainer.rank_mean(loss)), "before": before,
            "weights": tensors(running=False), "buffers": tensors(running=True),
            "digest": launch.state_digest(state)}


def resnet50_dp_rank() -> dict:
    """:func:`resnet50_step` on this rank of a 2-rank gloo mesh on the card."""
    mesh = create_mesh(WORLD, backend="gloo", device="cuda")
    return resnet50_step(mesh, "cuda")


def update_gap(a: dict, b: dict, before: dict, keys) -> float:
    """||a - b|| / ||b - before|| over the weights ``keys``: how far two
    steps' updates differ, relative to the step."""
    num = sum(float((a[k] - b[k]).double().square().sum()) for k in keys)
    den = sum(float((b[k] - before[k]).double().square().sum()) for k in keys)
    return (num / den) ** 0.5
