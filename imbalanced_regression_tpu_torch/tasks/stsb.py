"""STS-B-DIR driver on PyTorch: iteration-based training with periodic
validation and patience early stopping.

The reference's loop (``sts-b-dir/train.py`` + ``trainer.py:28-427``), as
the JAX package's ``tasks/stsb.py`` runs it: an endless reshuffled batch
stream over the device-resident train split (``Trainer.bind_device_data``),
validation every ``val_interval`` iterations (400), best by validation MSE
(a new best needs a strict improvement), a stop after ``patience`` (10)
checks without one or after ``max_vals`` (100) checks; the FDS stats pass
at each epoch rollover (``trainer.py:155-172``); the loss on targets / 5;
the final test with the best checkpoint, its predictions exported x5 and
clamped to [0, 5].

Run: ``python -m imbalanced_regression_tpu_torch.tasks.stsb --data_dir
<dir with train_new.tsv, dev_new.tsv, test_new.tsv> [--word_embs_file
<GloVe .txt>] [--lds --reweight inverse --fds ...]``. Runs on the GPU unless
``--device cpu`` is given. The encoder is the reference's at full width in
bf16 (d_word 300, d_hid 1500, 2 layers, a 12000-d pair embedding).

Checkpoints: every validation check writes ``latest.pt`` (and ``best.pt``
on a new best) in the store dir, with the validation history inside the
same file; ``--resume <store dir>`` goes on from ``latest`` (from ``best``
if there is no ``latest``) at the exact batch of the uninterrupted run;
``--evaluate [--resume <store dir> | --eval_model <store dir>]`` tests
``best`` (of the run's own store dir by default); ``--retrain_fc
--pretrained <store dir>`` is RRT stage 2 (the encoder of the stage-1
``best``, a fresh head, FDS statistics not restored). ``--cache_dir`` moves
the tokenization cache. ``--num_devices W`` trains data-parallel on W ranks,
as in ``tasks/age.py``: each rank gathers its rows of every index batch
from its own copy of the device-resident split; the interval's train loss
and statistics are the global batches'. ``--lstm_impl flax`` builds the
per-direction BiLSTM layout (``models/bilstm_pair.py``, the JAX package's
pre-round-4 checkpoints); a run that restores a checkpoint (``--resume``,
``--evaluate``, RRT's ``--pretrained``) takes the layout the checkpoint
was written with, whatever the flag says (:func:`match_ckpt_lstm_impl`).
Not ported: a positive ``--max_steps_per_run`` (which the JAX driver never
reads).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import sys
import time

import numpy as np
import torch

from imbalanced_regression_tpu_torch.data.batching import (
    eval_batches,
    index_iterator,
    infinite_index_batches,
)
from imbalanced_regression_tpu_torch.data.stsb import load_stsb_datasets
from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.models.bilstm_pair import PairBiLSTMEncoder
from imbalanced_regression_tpu_torch.models.resnet import RegressionHead
from imbalanced_regression_tpu_torch.parallel.launch import run_driver
from imbalanced_regression_tpu_torch.parallel.mesh import Mesh, rank0_first
from imbalanced_regression_tpu_torch.tasks.age import (
    check_data_parallel,
    data_parallel_mesh,
    setup_logging,
)
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig
from imbalanced_regression_tpu_torch.utils.checkpoint import (
    checkpoint_lstm_impl,
    checkpoint_meta,
    has_checkpoint,
    load_backbone_params,
    restore_checkpoint,
    save_checkpoint,
)
from imbalanced_regression_tpu_torch.utils.config import ExperimentConfig, build_parser
from imbalanced_regression_tpu_torch.utils.logging_tools import MetricsWriter, recorder, step_log
from imbalanced_regression_tpu_torch.utils.metrics import STSShotAverage

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class STSConfig(ExperimentConfig):
    """STS-B flags over the shared config (``sts-b-dir/train.py:19-95``)."""

    dataset: str = "stsb"
    loss: str = "mse"
    lr: float = 1e-4
    batch_size: int = 128
    bucket_num: int = 50
    lds_sigma: float = 2.0
    fds_sigma: float = 2.0
    max_seq_len: int = 40
    max_word_v_size: int = 30000
    word_embs_file: str = "glove/glove.840B.300d.txt"
    d_word: int = 300
    d_hid: int = 1500
    n_layers_enc: int = 2
    n_layers_highway: int = 0
    dropout: float = 0.2
    dropout_embs: float = 0.2
    glove: int = 1
    train_words: int = 0
    huber_beta: float = 0.3
    max_grad_norm: float = 5.0
    val_interval: int = 400
    max_vals: int = 100
    patience: int = 10
    eval_model: str = ""
    lstm_impl: str = "fused"  # 'fused' | 'flax' (the per-direction layout)


def parse_sts_config(argv=None) -> STSConfig:
    d = STSConfig()
    p = build_parser(d)
    for name, default in (
        ("max_seq_len", d.max_seq_len), ("max_word_v_size", d.max_word_v_size),
        ("word_embs_file", d.word_embs_file), ("d_word", d.d_word), ("d_hid", d.d_hid),
        ("n_layers_enc", d.n_layers_enc), ("n_layers_highway", d.n_layers_highway),
        ("dropout", d.dropout), ("dropout_embs", d.dropout_embs), ("glove", d.glove),
        ("train_words", d.train_words), ("huber_beta", d.huber_beta),
        ("max_grad_norm", d.max_grad_norm), ("val_interval", d.val_interval),
        ("max_vals", d.max_vals), ("patience", d.patience), ("eval_model", d.eval_model),
        ("lstm_impl", d.lstm_impl),
    ):
        p.add_argument(f"--{name}", type=type(default), default=default)
    args, _ = p.parse_known_args(argv)
    kw = vars(args)
    kw["schedule"] = tuple(kw["schedule"])
    return STSConfig(**kw)


def check_supported(config: STSConfig) -> None:
    """Raise for the flags whose code paths are not ported."""
    unported = {
        "--max_steps_per_run > 0": config.max_steps_per_run > 0,
    }
    missing = [flag for flag, used in unported.items() if used]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    check_data_parallel(config, config.batch_size)


def build_sts_trainer(config: STSConfig, vocab_size: int, emb_table: np.ndarray | None,
                      mesh: Mesh | None = None) -> Trainer:
    d_pair = 2 * config.d_hid * 4  # 12000 at the reference width
    fds_config = None
    if config.fds:
        fds_config = FDSConfig.for_sts(
            feature_dim=d_pair, bucket_num=config.bucket_num,
            start_update=config.start_update, start_smooth=config.start_smooth,
            kernel=config.fds_kernel, ks=config.fds_ks, sigma=config.fds_sigma,
            momentum=config.fds_mmt,
        )
        if config.bucket_start:
            fds_config = dataclasses.replace(fds_config, bucket_start=config.bucket_start)
    encoder = PairBiLSTMEncoder(
        vocab_size, d_word=config.d_word, d_hid=config.d_hid, n_layers=config.n_layers_enc,
        n_highway=config.n_layers_highway, dropout=config.dropout,
        dropout_embs=config.dropout_embs,
        # without GloVe the embeddings must be learned (models.py:25-31)
        train_words=bool(config.train_words) or not config.glove,
        embedding_table=emb_table if config.glove else None, lstm_impl=config.lstm_impl,
        dtype=torch.bfloat16,
    )
    tcfg = TrainerConfig(
        loss=config.loss, optimizer=config.optimizer, lr=config.lr, momentum=config.momentum,
        weight_decay=config.weight_decay, clip_grad_norm=config.max_grad_norm,
        huber_beta=config.huber_beta, target_scale=5.0, retrain_fc=config.retrain_fc,
        schedule=(),  # a flat lr (the reference's lr_decay is never applied)
    )
    return Trainer(encoder, RegressionHead(d_pair), tcfg, fds_config=fds_config,
                   device=config.device, mesh=mesh)


def match_ckpt_lstm_impl(config: STSConfig, ckpt_dir: str, which: str) -> STSConfig:
    """``config`` with the ``lstm_impl`` of the checkpoint about to be
    restored (``utils.checkpoint.checkpoint_lstm_impl``), logging the
    override as the JAX driver's ``_match_ckpt_lstm_impl`` does; unchanged
    where there is no checkpoint or its layout is the configured one."""
    impl = checkpoint_lstm_impl(ckpt_dir, which)
    if impl is not None and impl != config.lstm_impl:
        logger.warning("Checkpoint %s/%s was written with lstm_impl=%r; overriding configured "
                       "%r to match its parameter layout", ckpt_dir, which, impl,
                       config.lstm_impl)
        return dataclasses.replace(config, lstm_impl=impl)
    return config


def match_restored_layout(config: STSConfig, store_dir: str) -> STSConfig:
    """Probe the checkpoints a run restores, in the JAX driver's order: RRT
    stage 1's ``best``; under ``--evaluate`` the ``best`` of ``--resume``,
    ``--eval_model`` or the run's own store; else ``--resume``'s ``latest``,
    then ``best`` (the full-state restore binds when both are given)."""
    if config.retrain_fc and config.pretrained:
        config = match_ckpt_lstm_impl(config, config.pretrained, "best")
    if config.evaluate:
        return match_ckpt_lstm_impl(config, config.resume or config.eval_model or store_dir,
                                    "best")
    if config.resume:
        which = next((w for w in ("latest", "best") if has_checkpoint(config.resume, w)), None)
        if which:
            config = match_ckpt_lstm_impl(config, config.resume, which)
    return config


def is_new_best(history: list[float]) -> bool:
    """Whether ``history[-1]`` is a new best: strictly below every earlier
    score (``sts-b-dir/trainer.py:59-62``, should_decrease; a tie is not a
    new best)."""
    return len(history) == 1 or history[-1] < min(history[:-1])


def score_split(trainer, state, data, batch_size, return_preds: bool = False):
    scorer = STSShotAverage()
    preds, labels = trainer.predict(state, eval_batches(data, batch_size))
    scorer(preds.reshape(-1), labels.reshape(-1))
    metric = scorer.get_metric()
    if return_preds:
        return metric, preds, labels
    return metric


def export_predictions(store_dir: str, name: str, preds, labels) -> str:
    """Save test predictions the reference way: x5, clamped to [0, 5]
    (``sts-b-dir/evaluate.py:41``), in a compressed npz named after the
    store (``sts-b-dir/train.py:207``)."""
    path = os.path.join(store_dir, f"{name}.npz")
    clamped = np.clip(np.asarray(preds, np.float32).reshape(-1) * 5.0, 0.0, 5.0)
    np.savez_compressed(path, preds=clamped, labels=np.asarray(labels).reshape(-1))
    return path


def _log_shots(metric: dict, prefix: str):
    for shot in ("overall", "many", "medium", "few"):
        m = metric[shot]
        logger.info("%s * %s: MSE %.3f  L1 %.3f  G-Mean %.3f  Pearson %.3f  "
                    "Spearman %.3f  Number %d", prefix, shot.capitalize(),
                    m["mse"], m["l1"], m["gmean"], m["pearsonr"], m["spearmanr"],
                    m["num_samples"])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(config: STSConfig) -> dict:
    """Train with validation checks, then test the best checkpoint. Returns
    the test metrics, the best validation MSE, the iteration count, the
    validation history, one record per check (train loss, pairs/s), the
    stats passes' seconds, the FDS state at the end of training, the
    trainer and its (best) state. ``--evaluate`` returns the test metrics
    only."""
    check_supported(config)
    mesh = data_parallel_mesh(config)
    ranks = 1 if mesh is None else mesh.world_size
    rank0 = mesh is None or mesh.rank == 0
    store_dir = os.path.join(config.store_root, config.derived_store_name())
    setup_logging(store_dir, mesh)
    logger.info("Config: %s", config)

    # rank 0 writes the tokenization cache before the other ranks read it
    train, val, test, emb, vocab = rank0_first(
        mesh, lambda: load_stsb_datasets(config.data_dir, config))
    config = match_restored_layout(config, store_dir)
    trainer = build_sts_trainer(config, len(vocab), emb, mesh)
    state = trainer.init_state(config.seed)
    logger.info("Data: train=%d val=%d test=%d, vocabulary %d (device=%s, ranks=%d)",
                len(train["target"]), len(val["target"]), len(test["target"]), len(vocab),
                trainer.device, ranks)

    if config.evaluate:
        # --eval_model parity (sts-b-dir/train.py:196-207): the run's own
        # store dir when no checkpoint is named
        ckpt = config.resume or config.eval_model or store_dir
        state, _, _ = restore_checkpoint(ckpt, state, which="best")
        metric = score_split(trainer, state, test, config.batch_size)
        _log_shots(metric, "Test")
        return {"test": metric}

    if config.retrain_fc:
        # RRT stage 2 (sts-b-dir/train.py:180-191): the stage-1 encoder only
        # (util.py:75-84 loads pair_encoder.*; the head stays fresh and the
        # FDS statistics are not restored), then the head trains alone
        if not config.pretrained:
            raise ValueError("RRT stage 2 (--retrain_fc) needs --pretrained <stage-1 store dir>")
        state = load_backbone_params(config.pretrained, state, restore_fds=False)
        logger.info("RRT: loaded the encoder of %s; training the regression layer only",
                    config.pretrained)

    n_train = len(train["target"])
    n_tr_batches = max(n_train // config.batch_size, 1)
    history: list[float] = []
    best_mse, n_pass, real_epoch = math.inf, 0, 0
    resume_from = next((w for w in ("latest", "best")
                        if config.resume and has_checkpoint(config.resume, w)), None)
    if resume_from:
        state, real_epoch, best_mse = restore_checkpoint(config.resume, state, which=resume_from)
        n_pass = state.step
        # the validation history rides in the checkpoint: patience and
        # stopping decide as in the uninterrupted run (trainer.py:398-402)
        metric_state = checkpoint_meta(config.resume, resume_from).get("metric_state")
        if metric_state is not None:
            history = [float(h) for h in metric_state["hist"]]
            best_mse = float(metric_state["best"])
        else:
            history = [best_mse]
        logger.info("Resumed %s (%s) at iter %d (epoch %d, best val MSE %.4f)",
                    config.resume, resume_from, n_pass, real_epoch, best_mse)

    # per-epoch-seeded shuffles: a resumed stream goes on at the exact batch
    trainer.bind_device_data(train)
    gen = infinite_index_batches(n_train, config.batch_size, seed=111 + config.seed,
                                 start_batches=n_pass)
    max_iters = config.val_interval * config.max_vals
    writer = MetricsWriter(store_dir, enabled=rank0)
    train_scorer = STSShotAverage()
    train_losses, train_preds = [], []  # on the device until the next check
    checks, stats_seconds = [], []
    stopped = False
    _sync(trainer.device)
    t_interval, stats_in_interval = time.perf_counter(), 0.0
    interval_ns = time.time_ns()  # the interval's spans start here
    while not stopped and n_pass < max_iters:
        idx, _ = next(gen)
        state, loss, pred = trainer.train_step_indexed(state, idx, real_epoch)
        train_losses.append(loss)
        train_preds.append((pred, train["target"][idx]))
        n_pass += 1
        if n_pass % 100 == 0 and n_pass % config.val_interval != 0:
            loss.item()  # a heartbeat with a sync
            logger.info("iter %d/%d", n_pass, max_iters)

        if n_pass // n_tr_batches > real_epoch:
            # epoch rollover: the FDS stats pass over the device-resident
            # split in drop-last batches (trainer.py:155-172)
            _sync(trainer.device)
            t0 = time.perf_counter()
            state = trainer.fds_epoch_pass_indexed(
                state, index_iterator(n_train, config.batch_size,
                                      rng=np.random.default_rng(config.seed * 10007 + real_epoch)),
                real_epoch)
            _sync(trainer.device)
            stats_seconds.append(time.perf_counter() - t0)
            stats_in_interval += stats_seconds[-1]
            real_epoch += 1

        if n_pass % config.val_interval == 0:
            val_check = n_pass // config.val_interval
            # the interval's train statistics, fetched once (trainer.py:188-207);
            # under a mesh, of the global batches: every rank's predictions
            # and the ranks' mean loss
            preds_cat = trainer.all_rows(torch.stack([p for p, _ in train_preds]), dim=1)
            preds_cat = preds_cat.cpu().numpy()
            targs_cat = np.concatenate([t for _, t in train_preds])
            tr_loss = float(trainer.rank_mean(torch.stack(train_losses)).mean())
            train_seconds = time.perf_counter() - t_interval - stats_in_interval
            pairs_per_sec = len(train_losses) * config.batch_size / train_seconds
            train_scorer(preds_cat.reshape(-1), targs_cat.reshape(-1))
            logger.info("*** Val check %d (iter %d, epoch %d) ***", val_check, n_pass, real_epoch)
            logger.info("train loss: %.6f (%.1f pairs/s, %.1f pairs/s/rank)", tr_loss,
                        pairs_per_sec, pairs_per_sec / ranks)
            _log_shots(train_scorer.get_metric(reset=True), "Train")
            train_losses, train_preds = [], []

            metric = score_split(trainer, state, val, config.batch_size)
            cur = metric["overall"]["mse"]
            history.append(cur)
            _log_shots(metric, "Val")
            writer.log_dict({"train_loss": tr_loss, "pairs_per_sec": pairs_per_sec,
                             "pairs_per_sec_per_rank": pairs_per_sec / ranks,
                             **step_log(recorder.closed("step", "input_wait",
                                                        trainer=trainer.trace_id,
                                                        since_ns=interval_ns),
                                        trainer.graph_stats, trainer.pass_graph_stats)},
                            val_check)
            writer.log_dict(metric["overall"], val_check, prefix="val_")
            is_best = is_new_best(history)
            if is_best:
                best_mse = cur
            save_checkpoint(store_dir, state, real_epoch, best_mse, is_best,
                            metric_state={"hist": list(history), "best": best_mse})
            checks.append({"val_check": val_check, "iter": n_pass, "epoch": real_epoch,
                           "train_loss": tr_loss, "val_mse": cur, "train_seconds": train_seconds,
                           "pairs_per_sec": pairs_per_sec})
            # reference patience (trainer.py:50-74, should_decrease): out of
            # patience when the score is >= every score of the trailing
            # window of patience + 1 checks
            window = config.patience + 1
            if len(history) > window and max(history[-window:]) <= cur:
                logger.info("Out of patience after %d val checks", val_check)
                stopped = True
            _sync(trainer.device)
            t_interval, stats_in_interval = time.perf_counter(), 0.0
            interval_ns = time.time_ns()

    writer.close()
    logger.info("Training stopped after %d iterations (%d val checks)", n_pass, len(history))
    final_fds = state.fds
    state, best_epoch, best = restore_checkpoint(store_dir, state, which="best")
    logger.info("Loaded best checkpoint (epoch %d, val MSE %.4f)", best_epoch, best)
    metric, preds, labels = score_split(trainer, state, test, config.batch_size, return_preds=True)
    _log_shots(metric, "Test")
    if rank0:
        export_predictions(store_dir, config.store_name or "sts", preds, labels)
    return {"test": metric, "best_val_mse": best_mse, "iterations": n_pass,
            "val_history": history, "checks": checks, "stats_pass_seconds": stats_seconds,
            "final_fds": final_fds, "trainer": trainer, "state": state}


def main(argv=None):
    """Parse the flags and run (``--num_devices W > 1``: on W ranks, see
    :func:`parallel.launch.run_driver`)."""
    config = parse_sts_config(argv)
    check_supported(config)  # before any rank starts
    return run_driver(run, config)


if __name__ == "__main__":
    main(sys.argv[1:])
