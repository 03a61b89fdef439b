"""NYUD2-DIR driver on PyTorch: dense depth regression with per-pixel
LDS/FDS.

The reference's recipe (``nyud2-dir/train.py:66-264`` + ``test.py``), as the
JAX package's ``tasks/nyud2.py`` runs it: 10 epochs, Adam (lr 1e-4, L2
1e-4), lr x0.1 every 5 epochs, per-pixel weighted MSE, an FDS stats pass over
the clean FDS subset, a per-epoch test with bilinear upsampling to the depth
resolution and the balanced test mask, best by RMSE.

Run: ``python -m imbalanced_regression_tpu_torch.tasks.nyud2 --data_dir
<nyud2 data> [--fds --lds --reweight inverse ...]`` or ``--synthetic_size N``
for the synthetic stand-in at the reference's 228x304 crop (depth at
114x152). Runs on the GPU unless ``--device cpu`` is given.

Checkpoints as in ``tasks/age.py``: ``--save_ckpt 1`` (the default) writes
``latest.pt``/``best.pt`` every epoch, ``--ckpt_every_steps N`` also inside
an epoch, ``--resume <store dir>`` goes on from ``latest`` (from ``best`` if
there is no ``latest``), ``--evaluate --resume <store dir>`` tests ``best``.
``--pretrained_encoder <file.pth>`` initializes the encoder from a
torchvision-format ResNet state dict (the reference's ImageNet weights,
``nyud2-dir/train.py:110-114``). ``--retrain_fc`` freezes the whole
encoder-decoder and trains ``DepthHead`` only; ``--pretrained <store dir>``
(which the JAX driver does not read) loads the encoder-decoder and FDS
statistics of a stage-1 ``best`` first, for the two-stage RRT.
``--num_devices W`` trains data-parallel on W ranks, as in ``tasks/age.py``
(W must divide ``--batch_size``, ``--test_batch_size`` and the stats pass's
batch). ``--max_steps_per_run``, which the JAX driver never reads, is
refused when positive.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from imbalanced_regression_tpu_torch.convert import from_torchvision_resnet
from imbalanced_regression_tpu_torch.data.batching import batch_iterator, eval_batches
from imbalanced_regression_tpu_torch.data.nyud2 import (
    DEPTH_HW,
    IMG_HW,
    TRAIN_BUCKET_NUM,
    imagenet_normalize,
    load_nyud2_split,
    make_pixel_weight_fn,
    nyud2_train_photometric,
    synthetic_depth_dataset,
)
from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.models.depth_encdec import (
    DepthEncoderDecoder,
    DepthHead,
    depth_feature_dim,
)
from imbalanced_regression_tpu_torch.ops.lds import prepare_weights_depth
from imbalanced_regression_tpu_torch.parallel.launch import run_driver
from imbalanced_regression_tpu_torch.parallel.mesh import Mesh
from imbalanced_regression_tpu_torch.tasks.age import (
    check_data_parallel,
    data_parallel_mesh,
    setup_logging,
)
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig, snapshot_state
from imbalanced_regression_tpu_torch.utils.checkpoint import (
    has_checkpoint,
    load_backbone_params,
    restore_checkpoint,
    save_checkpoint,
)
from imbalanced_regression_tpu_torch.utils.config import ExperimentConfig, build_parser
from imbalanced_regression_tpu_torch.utils.logging_tools import (
    MetricsWriter,
    host_memory_gb,
    recorder,
    step_log,
)
from imbalanced_regression_tpu_torch.utils.metrics import DepthEvaluator

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class NYUDConfig(ExperimentConfig):
    dataset: str = "nyud2"
    loss: str = "mse"
    lr: float = 1e-4
    epoch: int = 10
    batch_size: int = 32
    bucket_start: int = 7
    lds_sigma: float = 2.0
    fds_sigma: float = 2.0
    weight_decay: float = 1e-4
    test_batch_size: int = 8
    fds_subset_limit: int = 0  # cap FDS subset size (0 = all)
    # ImageNet-pretrained encoder (the reference loads torchvision's
    # resnet50 weights, nyud2-dir/train.py:110-114): a torchvision .pth
    pretrained_encoder: str = ""
    # model scaling knobs (tests shrink these)
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    # channel knobs of DepthEncoderDecoder (0 / 16 = the reference widths)
    mff_features: int = 16
    decoder_min_features: int = 0


def parse_nyud_config(argv=None) -> NYUDConfig:
    d = NYUDConfig()
    p = build_parser(d)
    p.add_argument("--test_batch_size", type=int, default=d.test_batch_size)
    p.add_argument("--fds_subset_limit", type=int, default=d.fds_subset_limit)
    p.add_argument("--pretrained_encoder", type=str, default=d.pretrained_encoder,
                   help="torchvision-format ResNet .pth state dict for the encoder")
    p.add_argument("--mff_features", type=int, default=d.mff_features,
                   help="MFF per-scale channels (reference: 16)")
    p.add_argument("--decoder_min_features", type=int, default=d.decoder_min_features,
                   help="pad decoder stages to >= this many channels (0 = reference)")
    args, _ = p.parse_known_args(argv)
    kw = vars(args)
    kw["schedule"] = tuple(kw["schedule"])
    return NYUDConfig(**kw)


def check_supported(config: NYUDConfig) -> None:
    """Raise for the flags whose code paths are not ported, and for a
    train or test batch that the data-parallel ranks cannot split (the
    stats pass's batch is checked once the FDS subset's size is known)."""
    unported = {
        "--max_steps_per_run > 0": config.max_steps_per_run > 0,
    }
    missing = [flag for flag, used in unported.items() if used]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    check_data_parallel(config, config.batch_size, config.test_batch_size)


def build_nyud_trainer(config: NYUDConfig, mesh: Mesh | None = None) -> Trainer:
    feat_dim = depth_feature_dim(num_features=config.width * 32,
                                 mff_features=config.mff_features,
                                 decoder_min_features=config.decoder_min_features)
    fds_config = None
    if config.fds:
        fds_config = FDSConfig.for_depth(
            feature_dim=feat_dim, bucket_num=config.bucket_num, bucket_start=config.bucket_start,
            start_update=config.start_update, start_smooth=config.start_smooth,
            kernel=config.fds_kernel, ks=config.fds_ks, sigma=config.fds_sigma,
            momentum=config.fds_mmt,
        )
    bucket_weights = prepare_weights_depth(
        TRAIN_BUCKET_NUM, config.reweight, bucket_num=100, bucket_start=config.bucket_start,
        lds=config.lds, lds_kernel=config.lds_kernel, lds_ks=config.lds_ks,
        lds_sigma=config.lds_sigma,
    ) if config.reweight != "none" else None

    # lr * 0.1 ** (epoch // 5) (train.py:230-234): a milestone every 5 epochs
    tcfg = TrainerConfig(loss=config.loss, lr=config.lr, adam_weight_decay=config.weight_decay,
                         schedule=tuple(range(5, config.epoch, 5)), retrain_fc=config.retrain_fc)
    backbone = DepthEncoderDecoder(stage_sizes=tuple(config.stage_sizes), width=config.width,
                                   mff_features=config.mff_features,
                                   decoder_min_features=config.decoder_min_features,
                                   dtype=torch.bfloat16)
    return Trainer(
        backbone, DepthHead(feat_dim), tcfg, fds_config=fds_config,
        train_augment=nyud2_train_photometric, eval_transform=imagenet_normalize,
        weight_fn=make_pixel_weight_fn(bucket_weights), device=config.device, mesh=mesh,
    )


def _span(trainer, name: str, rows: int = -1):
    """A span of ``trainer``'s (``utils.logging_tools.recorder``), of the
    epoch it last stepped or passed in; a stand-in predictor without a
    trace id records under none."""
    return recorder.span(name, getattr(trainer, "trace_id", -1), getattr(trainer, "_epoch", -1),
                         rows)


def test_epoch(trainer, state, test_data, batch_size) -> dict:
    """Per-epoch evaluation: upsample predictions to depth resolution and
    apply the balanced per-pixel mask (test.py:39-59). The pass is a
    ``test`` span of the trainer's epoch; inside it each batch's host
    upsample is an ``upsample`` span, and each batch's mask and metric
    accumulation, and the final scoring, ``shot_metrics`` spans."""
    evaluator = DepthEvaluator()
    mask = test_data.get("mask")
    offset = 0
    data = {k: v for k, v in test_data.items() if k != "mask"}
    with _span(trainer, "test"):
        for batch in eval_batches(data, batch_size):
            count = batch.pop("count")
            pred = trainer.predict_batch(state, batch, count)
            depth = np.asarray(batch["target"])[:count]
            if pred.shape[1:3] != depth.shape[1:3]:
                with _span(trainer, "upsample", count):
                    nchw = torch.from_numpy(pred).permute(0, 3, 1, 2)
                    pred = F.interpolate(nchw, size=depth.shape[1:3], mode="bilinear",
                                         align_corners=False).permute(0, 2, 3, 1).numpy()
            with _span(trainer, "shot_metrics", count):
                if mask is not None:
                    m = mask[offset : offset + count]
                    m = m[..., None] if m.ndim == 3 else m
                    evaluator(pred[m], depth[m])
                else:
                    evaluator(pred, depth)
            offset += count
        with _span(trainer, "shot_metrics"):
            return evaluator.evaluate_shot()


def build_data(config: NYUDConfig):
    if config.synthetic_size:
        n = config.synthetic_size
        full = synthetic_depth_dataset(n, img_hw=IMG_HW, depth_hw=DEPTH_HW)  # the reference's crop
        tr = int(n * 0.8)
        train = {k: v[:tr] for k, v in full.items()}
        test = {k: v[tr:] for k, v in full.items()}
        fds_subset = {k: v[: max(tr // 4, 1)] for k, v in train.items()}
        return train, fds_subset, test
    train = load_nyud2_split(config.data_dir, "nyu2_train.csv", train=True)
    fds_subset = load_nyud2_split(config.data_dir, "nyu2_train_FDS_subset.csv", train=True,
                                  limit=config.fds_subset_limit or None)
    test = load_nyud2_split(config.data_dir, "nyu2_test.csv", train=False,
                            mask_file="test_balanced_mask.npy")
    return train, fds_subset, test


def load_pretrained_encoder(state, path: str):
    """Initialize the encoder from a torchvision-format ResNet state dict
    (``.pth``), as the reference's ``resnet.resnet50(pretrained=True)``
    (``nyud2-dir/train.py:110-114``); ``fc.*`` is dropped and any other key
    the encoder lacks raises."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    state.backbone.encoder.load_state_dict(from_torchvision_resnet(sd))
    return state


def run(config: NYUDConfig) -> dict:
    """Train with a per-epoch FDS pass and test, keeping the best state (by
    test RMSE) on disk (``--save_ckpt 1``) or in memory. Returns the best
    epoch's test metrics, the per-epoch history of this run, the trainer,
    its state (after the last epoch; the best one's with ``--save_ckpt 1``)
    and, with ``--save_ckpt 0``, the snapshot of the best one.
    ``--evaluate`` returns the test metrics only."""
    check_supported(config)
    mesh = data_parallel_mesh(config)
    ranks = 1 if mesh is None else mesh.world_size
    store_dir = os.path.join(config.store_root, config.derived_store_name())
    setup_logging(store_dir, mesh)
    logger.info("Config: %s", config)

    train, fds_subset, test = build_data(config)
    fds_batch = min(config.batch_size, len(fds_subset["target"]))
    check_data_parallel(config, fds_batch)
    trainer = build_nyud_trainer(config, mesh)
    logger.info("Data: train=%d fds_subset=%d test=%d (device=%s, ranks=%d)",
                len(train["target"]), len(fds_subset["target"]), len(test["target"]),
                trainer.device, ranks)
    state = trainer.init_state(config.seed)
    if config.pretrained_encoder:
        state = load_pretrained_encoder(state, config.pretrained_encoder)
        logger.info("Encoder initialized from %s", config.pretrained_encoder)

    if config.evaluate:
        assert config.resume, "Specify a trained model via --resume"
        state, _, _ = restore_checkpoint(config.resume, state, which="best")
        metric = test_epoch(trainer, state, test, config.test_batch_size)
        _log_metrics(metric)
        return {"test": metric}

    if config.pretrained:
        state = load_backbone_params(config.pretrained, state)
        logger.info("Loaded pretrained encoder-decoder: %s", config.pretrained)

    writer = MetricsWriter(store_dir, enabled=mesh is None or mesh.rank == 0)
    best_rmse, best_metric, best_epoch, best_snapshot = float("inf"), None, -1, None
    # per-epoch-seeded shuffles + step-located resume, as in tasks/age.py
    # (the reference restarts whole epochs, nyud2-dir/train.py:117-126)
    steps_per_epoch = max(len(train["target"]) // config.batch_size, 1)
    start_epoch, start_step = 0, 0
    if config.resume:
        # the reference's --resume restores the latest checkpoint
        # (train.py:117-126); fall back to best
        for which in ("latest", "best"):
            if has_checkpoint(config.resume, which):
                state, start_epoch, best_rmse = restore_checkpoint(config.resume, state, which)
                start_step = state.step - start_epoch * steps_per_epoch
                if not 0 <= start_step <= steps_per_epoch:
                    start_step = 0
                logger.info("Resumed %s (%s) at epoch %d step %d (best RMSE %.3f)",
                            config.resume, which, start_epoch, start_step, best_rmse)
                break
    history = []
    for epoch in range(start_epoch, config.epoch):
        calibrating = bool(
            config.fds and epoch >= trainer.fds_config.start_smooth
            and ((state.fds.running_mean_last_epoch != 0).any()
                 | (state.fds.running_var_last_epoch != 1).any()).item())
        step_hook = None
        if config.save_ckpt and config.ckpt_every_steps:
            def step_hook(s, _step, e=epoch):
                save_checkpoint(store_dir, s, e, best_rmse, is_best=False)
        first = start_step if epoch == start_epoch else 0
        t0 = time.time()
        state, train_loss = trainer.train_epoch(
            state, batch_iterator(train, config.batch_size,
                                  rng=np.random.default_rng((config.seed, epoch)), skip=first),
            epoch, start_step=first, step_hook=step_hook, hook_every=config.ckpt_every_steps)
        train_dt = time.time() - t0  # train_epoch ends in a device sync
        # FDS pass over the clean FDS subset, in order (train.py:216-228)
        t1 = time.time()
        state = trainer.fds_epoch_pass(
            state, batch_iterator(fds_subset, fds_batch, shuffle=False), epoch)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        fds_dt = time.time() - t1
        metric = test_epoch(trainer, state, test, config.test_batch_size)
        rmse = metric["overall"]["RMSE"]
        is_best = rmse < best_rmse
        if is_best:
            best_rmse, best_metric, best_epoch = rmse, metric, epoch
        if config.save_ckpt:
            save_checkpoint(store_dir, state, epoch + 1, best_rmse, is_best)
        elif is_best:
            best_snapshot = snapshot_state(state)
        throughput = (steps_per_epoch - first) * config.batch_size / train_dt
        rss, peak_rss = host_memory_gb()
        scalars = {"train_loss": train_loss, "test_rmse": rmse, "images_per_sec": throughput,
                   "images_per_sec_per_rank": throughput / ranks, "train_seconds": train_dt, "fds_pass_seconds": fds_dt, "host_rss_gb": rss,
                   "host_peak_rss_gb": peak_rss,
                   **step_log(recorder.closed("step", "input_wait", trainer=trainer.trace_id,
                                              epochs={epoch}), trainer.graph_stats,
                                     trainer.pass_graph_stats)}
        writer.log_dict(scalars, epoch)
        writer.log_dict(metric["overall"], epoch, prefix="test_")
        history.append({"epoch": epoch, "fds_calibrating": calibrating, **scalars})
        logger.info("Epoch %d: train loss %.4f  test RMSE %.3f (best %.3f)  (%.1fs, %.1f img/s, "
                    "%.1f img/s/rank, fds pass %.2fs)", epoch, train_loss, rmse, best_rmse,
                    train_dt, throughput, throughput / ranks, fds_dt)

    writer.close()
    if config.save_ckpt:
        # the best epoch may predate a resume: test the best checkpoint
        state, after_epoch, _ = restore_checkpoint(store_dir, state, which="best")
        best_epoch, best_metric = after_epoch - 1, test_epoch(trainer, state, test,
                                                               config.test_batch_size)
    logger.info("Best epoch: %d; RMSE: %.3f", best_epoch, best_rmse)
    _log_metrics(best_metric)
    return {"test": best_metric, "best_rmse": best_rmse, "best_epoch": best_epoch,
            "history": history, "trainer": trainer, "state": state,
            "best_snapshot": best_snapshot}


def _log_metrics(metric: dict):
    logger.info("***** TEST RESULTS *****")
    for shot in ("overall", "many", "medium", "few"):
        m = metric[shot]
        logger.info(" * %s: RMSE %.3f  ABS_REL %.3f  LG10 %.3f  MAE %.3f  "
                    "DELTA1 %.3f  DELTA2 %.3f  DELTA3 %.3f  NUM %d",
                    shot.capitalize(), m["RMSE"], m["ABS_REL"], m["LG10"], m["MAE"],
                    m["DELTA1"], m["DELTA2"], m["DELTA3"], m["NUM"])


def main(argv=None):
    """Parse the flags and run (``--num_devices W > 1``: on W ranks, see
    :func:`parallel.launch.run_driver`)."""
    config = parse_nyud_config(argv)
    check_supported(config)  # before any rank starts
    return run_driver(run, config)


if __name__ == "__main__":
    main(sys.argv[1:])
