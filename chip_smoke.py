"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # every phase, as CI on the card runs it
    python3 chip_smoke.py --profile  # adds profiled windows of age, depth and STS-B train steps

``--profile`` is a measurement tool for ``PERF.md``'s step breakdown; no
check reads it.

Phases:
1. build the CUDA kernels from ``imbalanced_regression_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card, at the
   age path's batch (N = 64 rows, D = 2048, B = 100 buckets), where K1-K3
   are timed, and at N = 128 (the bench's batch, where K1 and K2 are timed
   too; K3/K4 also at N = 8192); K4 is timed at N = 64 too, for the record
   only (the age path does not run it); the LSTM cell at the STS-B shape;
   the MoE dispatch and combine at the DeepSeek-V2 cell's layer (10,240
   tokens, top-6 of 64 experts, 8 held, D = 2,048, bf16);
3. the same at the NYUD2 stats-pass and train-step shape (N = 32 x 114 x
   152 = 554,496 pixels, D = 128, B = 93): K1/K2 against their plain
   versions in "positive" guard mode; K3/K4 against a float64 reference
   (exact counts, sums within 1e-5 of the bucket's sum of |f| or of f*f) and
   bit-identical across two runs; all four timed; K3 and K4 also on an
   index in runs of equal buckets along rows of 152 pixels, as a depth map
   gives;
4. drive the port's age train path (``tasks/age.py``: ResNet-50 in bf16 +
   LDS + FDS, three epochs on synthetic 224x224 images), with the kernel
   launch counters set to 0 just before and read just after;
5. the same for the NYUD2 dense-depth train path (``tasks/nyud2.py``:
   ResNet-50 encoder-decoder in bf16 + per-pixel LDS/FDS, three epochs of
   4 steps of batch 32 on synthetic 228x304 images);
6. one stats-pass batch of the trained depth model, whose encodings go
   through ``fds_bucket_moments`` with K3 and with K4 (``use_kernel="v2"``),
   held against a float64 reference and each other, and timed on them
   (with their bounds, plain versions and ``index_add_``);
7. the depth decoder's bf16 resize against float64 (output and gradient),
   and timed against ``F.interpolate``;
8. age resume: the age path with ``--save_ckpt 1 --ckpt_every_steps 3
   --epoch 2`` run once uninterrupted, once killed right after its second
   mid-epoch save and resumed with ``--resume``; test metrics, best loss and
   both checkpoints (backbone, head, optimizer, FDS state, step, generator)
   bit-equal, under ``cudnn.deterministic`` (the pair is run again without
   it and whether it was bit-equal is logged); the checkpoint's bytes and
   save and restore seconds are logged;
9. RRT stage 2 on phase 8's store (``--retrain_fc --pretrained``): backbone
   weights bit-equal to stage 1's best, the head moved, epoch 1 calibrated
   with the restored FDS snapshot, K1 and K3 launched and K2 not; then
   ``--evaluate --resume`` on stage 2's store reproduces its final test;
10. depth resume: the NYUD2 path with ``--save_ckpt 1 --ckpt_every_steps 2
   --epoch 2``, killed and resumed as in phase 8; equal test metrics, best
   epoch and checkpoints;
11. the STS-B-DIR train path (``tasks/stsb.py``: GloVe + the fused BiLSTM
   pair encoder at full width in bf16, a 12000-d pair embedding, LDS +
   FDS in the ``hist`` grouping, indexed training) on a synthetic corpus
   in the GLUE STS-B layout at STS-B-DIR's split sizes (5,249 / 1,000 /
   1,000 pairs) with a GloVe-format file of random vectors: 90 iterations
   of batch 128 (41 an epoch), a validation check every 30, two stats
   passes; K1 and K2 run in the 49 steps from epoch 1 on, the last 8 with
   the first pass's statistics (the snapshot a step calibrates with lags
   one pass, as in the reference); the LSTM cell kernels launch
   ``n_layers_enc x max_seq_len`` times forward in each train step,
   stats-pass batch and evaluation batch, and as many times backward in
   each train step (phase 12 too: its killed and resumed runs together as
   phase 11, its ``--evaluate`` the test batches' forwards);
12. STS-B resume: the phase-11 run killed right after validation check 1
   wrote its checkpoint (the validation history inside it) and resumed
   with ``--resume``; validation history, iterations, test metrics and both
   checkpoints bit-equal to phase 11's; then ``--evaluate --resume`` on
   its store.

13. the age driver on real files at AgeDB-DIR's sizes: a meta CSV of
   16,488 rows (12,208 / 2,140 / 2,140, the DIR splits; train ages skewed
   toward 25-45, val and test balanced over 0-101), each row a copy of one
   of the committed fixture JPEGs (``tests/data/torch_age_jpegs/``), then
   ``--dataset agedb --batch_size 256 --epoch 2 --fds --lds --reweight
   sqrt_inv`` in the ``auto`` mode (ram, 2.48 GB): ResNet-50 in bf16, 47
   steps an epoch, K1/K2 in epoch 1, K3 in both stats passes; decode img/s,
   data-load seconds, img/s and peak host RSS logged. Then the first 1,024
   rows, batch 64, one epoch, in ram, mmap and stream mode under
   ``cudnn.deterministic``: losses and test metrics bit-equal, each mode's
   img/s, peak RSS and the mmap cache build logged. Where the native loader
   cannot be built (no libjpeg), the loader decodes through PIL, as the
   driver does; where PIL is missing too, the phase says so, writes the
   mmap caches itself from a seed and runs the full-size run in mmap mode
   only;
14. serving: phase 8's age store (ResNet-50 in bf16) exported by
   ``tools/export_model.py`` for uint8 224x224 batches of 128, phase 10's
   depth store for float32 228x304 batches of 8, phase 11's STS-B store
   (d_hid 1500, bf16) by ``serving.export_predictor`` for batches of 128
   pairs padded to 40 tokens; each artifact loaded and held against
   ``Trainer.predict_batch`` on the same restored state and batch under
   ``cudnn.deterministic`` (within 2^-6 of the largest magnitude; whether
   bit-equal is logged), a batch of another size refused, export, load and
   call times and artifact bytes logged; then ``tools/serve_bench.py`` on
   the age store at batches 1, 8, 32 and 128. No FDS kernel and no LSTM
   cell backward may launch during the phase;
15. data parallelism (``parallel/``) on the card: (a) the age path of
   phase 4 at a global batch of 128 for two epochs on two ranks sharing
   the card through gloo (``--num_devices 2 --dist_backend gloo``, which
   the driver starts itself), beside one process, both under
   ``cudnn.deterministic``: the ranks' weights, BN buffers and FDS state
   bit-identical, the FDS counts equal to the one process's, losses and
   test metrics within 10% relative, and K1, K2 and K3 launched on both
   ranks as many times as the step counts predict; per-rank img/s and the
   seconds in collectives logged (two ranks on one card: a correctness
   gate, not a scaling number); (c) a one-rank NCCL group's float32
   ResNet-50 step bit-equal to the step without a mesh; (b) that step on
   two gloo ranks against one process (loss within 1e-5 relative, rtol
   1e-4 / atol 1e-5 on the BN buffers and the head; the backbone's
   update within 4 times the gap a 2^-23 input perturbation makes, as its
   float32 gradients at init are ill-conditioned); (d)
   ``dryrun_multichip(2, "cuda")``'s checks, on the same two ranks as (b)
   (one start-up of the ranks for both); and K1-K3
   at the depth path's rows a rank (N = 16 x 114 x 152), timed and logged;
16. the experiment tools at full width: (a) ``tools/bench.py`` at its
   defaults (ResNet-50 in bf16, batch 128 of 224x224 uint8 images, FDS
   calibrating every step; 5 warm-up and 20 timed steps): its JSON line
   logged, K1 and K2 launched 25 times each and K3 not; (b)
   ``tools/sweep.py`` on 320 synthetic 224x224 images, 2 epochs, over l1 x
   {none, sqrt_inv} x LDS {0, 1} x FDS {1} with ``--rrt --rrt_from self``:
   three stage-1 runs and two RRT stage-2 runs, each timed, K1-K3 launched
   as the step counts predict; the same command again skips every run
   from its JSONL and launches nothing; the port's aggregate table; (c)
   the STS-B driver with ``--lstm_impl flax`` (the per-direction BiLSTM, d_hid
   1500, bf16) on phase 11's corpus, 45 iterations with one stats pass and
   one validation check, K1-K3 launched as predicted; ``--evaluate
   --resume`` on its store without the flag takes the layout from the
   checkpoint and reproduces the run's test metrics; then the train step in
   the fused and the per-direction layouts side by side (host-clock ms and
   the profiler's device busy ms a step); (d) the dataset tools on the
   card's machine, which has no pandas: a 600-image synthetic corpus, its
   AgeDB meta CSV and balanced splits, a NYUD2 FDS subset and corpus word
   vectors from 400 of phase 11's pairs. The phase's seconds are logged;
17. the tutorial and the entry: (a) K1 and K2 bit-equal to their plain
   versions at the tutorial's step (N = 128, D = 64, B = 51: a row tile
   of 16 threads) and K3 against its plain version and float64 at its
   stats pass (N = 1,749, D = 64), each timed; (b)
   ``tutorial/tutorial.py`` run as it is on the card (``--device cuda``):
   K1 and K2 launched 182 times (13 steps in each of epochs 1-14), K3 15
   (one stats pass an epoch); then its ``train`` and ``evaluate`` on the
   card and on the CPU from the same weights and permutations, first-epoch
   losses within 1e-5 and final MAEs within 1% relative; (c)
   ``tools/make_notebook.py --device cuda`` into a temporary directory,
   every code cell executed and the same cells with outputs as the
   committed notebook; (d) ``entry()``: a finite (8, 1) output, equal to
   the CPU forward on the zero batch and within 2^-6 of it on a seeded
   batch, its host-clock and CUDA-event ms at batch 8;
18. the graphed train step (``train.py`` ``StepGraphs``) against the eager
   one at the two benchmark cells' shapes: the AgeDB-DIR ResNet-50 in bf16
   at batch 256 (``train_epoch`` over staged batches) and the STS-B-DIR
   BiLSTM at full width at batch 128 (indexed steps), each from the same
   seeds through stats passes at epochs 0 and 1, three steps, a stats pass
   (new tables for K1/K2) and three more steps: losses, weights, BN
   buffers, Adam's state, the FDS state and the generator bit-equal under
   ``cudnn.deterministic``; then ``GRAPH_TIMED`` steps of each side timed:
   the host's ms a step (the median ``step`` span) and the ms a step by
   CUDA events around them (the device's period where the host runs
   ahead).
19. the STS-B driver with ``--encoder deepseek_v2`` at DeepSeek-V2-Lite's
   widths and vocabulary, cut to the dense layer and one MoE layer
   (``STS_MOE_ARGV``), 45 iterations over phase 11's corpus with a stats
   pass and one validation check: steps and pass batches replayed as
   graphs, the dispatch kernels launched exactly as many times as the
   run's forwards and steps call them (``sts_moe_launches``), every held
   expert routed rows; its launches go into the ``kernels`` line.

Phase 2 also holds K1, K2 and K3 at the STS-B shape (N = 128, D = 12000,
B = 50, ``positive`` mode with clip [0.5, 2.0], an empty bucket and rows of
a bucket whose v1 sums to under 1e-10) and times them there; K1 and K2
bit-equal to their plain versions; and at phase 13's batch (N = 256, D =
2048, B = 97: AgeDB's buckets 3-99).

Phase 2 also holds K1 and K2 bit-equal to their plain versions at the
boundary of ``calibrate_plan``'s two forms (``calibrate_regimes``: the
factored form's least rows and one row short, at D = 128 and at D = 130,
the scalar path). Every K1/K2 record is timed with the statistics cold
(``cold_tables``), as a train step finds them; x stays warm.

Phase 2 also holds the LSTM cell kernels (``csrc/lstm_cell.cu``) against
the plain cell at the STS-B cell's shape (512 rows, H = 1500, 40 steps,
bf16) and times them forward (with and without the saved gates) and
backward beside ATen's fused cell (``torch._thnn_fused_lstm_cell`` and
``_thnn_fused_lstm_cell_backward_impl``) on the same gates, then counts a
full-width layer's cell launches (``lstm_cell_phase``). Its records go
into the ``kernels`` line with the launches of phases 11 and 12.

Phase 2 also times the per-node floor of a replayed CUDA graph (a
one-element ``add_``), which bounds the device time of a kernel at the age
path's tiny shapes from below. Phases 4-6 also check that K3 ran the
kernel its plan names for the shape: the short-batch kernel on the age
path, the row split on the depth path.
``k3_probe.py`` holds the measurements behind K3's design choices.

Prints the card's name and power limit, a ``{"serving": {...}}`` line
(phase 14's records), a ``{"graphed_step": {...}}`` line (phase 18's
timings), a ``{"kernels": [...]}`` line (one record per kernel
and shape) and as the last line ``{"ok": true, "device":
{...}}``. Exits non-zero, with no result line, when there is no CUDA device
or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
L2_BYTES = 50e6  # H100 L2 cache, NVIDIA data sheet
MAX_COLD_COPIES = 64  # copies of the calibrate statistics that cold_tables cycles
AGE = (2048, 100)  # (D, B): ResNet-50 encoding width, age buckets
MAIN_ARGV = ["--synthetic_size", "640", "--img_size", "224", "--batch_size", "64",
             "--epoch", "3", "--fds", "--lds", "--reweight", "sqrt_inv", "--save_ckpt", "0",
             "--model", "resnet50", "--store_root", "runs/chip_smoke"]
N_MAIN = int(MAIN_ARGV[MAIN_ARGV.index("--batch_size") + 1])  # rows per kernel call on the path
# NYUD2: 160 synthetic images at the reference's 228x304 crop = 128 train
# (4 steps of 32), an FDS subset of 32 (one stats-pass batch) and 32 test
DEPTH_ARGV = ["--synthetic_size", "160", "--batch_size", "32", "--epoch", "3", "--fds", "--lds",
              "--reweight", "inverse", "--save_ckpt", "0", "--store_root", "runs/chip_smoke"]
DEPTH_BATCH = int(DEPTH_ARGV[DEPTH_ARGV.index("--batch_size") + 1])
DEPTH_HW = (114, 152)  # the hook's resolution: half the 228x304 input
N_DEPTH = DEPTH_BATCH * DEPTH_HW[0] * DEPTH_HW[1]  # rows per kernel call on the path
DEPTH = (128, 93)  # (D, B): the hook width, buckets 7..99
# the bf16 resize against float64, as a share of the largest magnitude: the
# weights, the width pass and the output each rounded to bf16 (2**-9)
RESIZE_TOL = 2.0**-6
# phases 8-10: the paths with checkpoints, two epochs each, in their own
# store roots (argparse keeps the last of a repeated flag)
RESUME_ROOT = "runs/chip_smoke/resume"
AGE_RESUME_ARGV = MAIN_ARGV + ["--save_ckpt", "1", "--ckpt_every_steps", "3", "--epoch", "2"]
RRT_ARGV = MAIN_ARGV + ["--save_ckpt", "1", "--epoch", "2", "--retrain_fc", "--reweight",
                        "sqrt_inv", "--fds"]
DEPTH_RESUME_ARGV = DEPTH_ARGV + ["--save_ckpt", "1", "--ckpt_every_steps", "2", "--epoch", "2"]
# STS-B-DIR: the reference recipe on a synthetic corpus at its split sizes
STS = (12000, 50)  # (D, B): the pair embedding 2 * 1500 * 4, the histogram buckets
STS_DIR = "runs/chip_smoke/stsb_data"
STS_SPLITS = (("train_new.tsv", 5249), ("dev_new.tsv", 1000), ("test_new.tsv", 1000))
STS_VOCAB = 12000  # made-up words, drawn by a Zipf law
STS_ARGV = ["--data_dir", STS_DIR, "--word_embs_file", f"{STS_DIR}/glove.txt", "--glove", "1",
            "--fds", "--lds", "--reweight", "inverse", "--val_interval", "30", "--max_vals", "3",
            "--cache_dir", f"{STS_DIR}/cache"]
STS_BATCH = 128  # the recipe's batch: rows per kernel call on the path
# AgeDB-DIR: the recipe's batch on a real-file corpus at the DIR split sizes
AGEDB_DIR = "runs/chip_smoke/agedb_data"
AGEDB_SPLITS = (("train", 12208), ("val", 2140), ("test", 2140))
AGEDB_ARGV = ["--dataset", "agedb", "--data_dir", AGEDB_DIR, "--img_size", "224",
              "--batch_size", "256", "--epoch", "2", "--fds", "--lds", "--reweight", "sqrt_inv",
              "--save_ckpt", "0", "--store_root", "runs/chip_smoke"]
AGEDB_BATCH = int(AGEDB_ARGV[AGEDB_ARGV.index("--batch_size") + 1])
AGEDB = (2048, 97)  # (D, B): buckets 3..99 (agedb's bucket_start 3)
# the mode legs: the CSV's first rows, batch 64, one epoch, paths into the corpus
LEGS_DIR, LEG_ROWS = f"{AGEDB_DIR}/legs", 1024
LEG_ARGV = ["--dataset", "agedb", "--data_dir", LEGS_DIR, "--img_size", "224", "--batch_size",
            "64", "--epoch", "1", "--fds", "--lds", "--reweight", "sqrt_inv", "--save_ckpt", "0",
            "--store_root", "runs/chip_smoke"]
FIXTURE_JPEGS = "tests/data/torch_age_jpegs"
# phase 14: the frozen predictors of phases 8, 10 and 11's stores
SERVE_DIR = "runs/chip_smoke/serving"
SERVE_AGE_BATCH, SERVE_DEPTH_BATCH, SERVE_STS_BATCH = 128, 8, 128
SERVE_BENCH_BATCHES = ("1", "8", "32", "128")
# a predictor against predict_batch, as a share of the largest magnitude:
# both run the same aten ops, so they are expected bit-equal; 2^-6 bounds
# what one cuDNN algorithm for another could change in the bf16 models
SERVE_TOL = 2.0**-6
# phase 15: data parallelism, two ranks sharing the card through gloo
DP_RANKS = 2
DP_ARGV = MAIN_ARGV + ["--batch_size", "128", "--epoch", "2"]
# DP against one process on the bf16 age path: losses and test metrics
# within 10% relative. bf16, and conv algorithms that differ between 64 and
# 128 rows, rule out bit-equality; the first card run of this phase showed
# gaps of up to 4.97% (test MSE; 2.82% on epoch 1's train loss) after six
# Adam steps, whose first moves every weight by about lr * sign(g): the
# bound is twice that
DP_REL_TOL = 0.10
DP_F32_BATCH = 32  # the float32 step: global batch, 224x224
# phase 16: the experiment tools. The bench at its defaults (ResNet-50 in
# bf16, batch 128 of 224x224 uint8 images, 5 + 20 steps, K1/K2 every step)
BENCH_BATCH = 128  # tools/bench.py's batch: K1/K2's rows there
TOOLS_ROOT = "runs/chip_smoke/tools"
# the sweep: ResNet-50 at 224x224 on 320 synthetic images (3 steps of 64
# an epoch), 2 epochs; grid l1 x {none, sqrt_inv} x LDS {0, 1} x FDS {1}:
# 3 stage-1 cells (LDS needs re-weighting) and stage 2 of the 2
# re-weighted ones on their own stores, all with FDS
SWEEP_ARGV = ["--synthetic_size", "320", "--img_size", "224", "--batch_size", "64", "--epoch",
              "2", "--losses", "l1", "--reweights", "none", "sqrt_inv", "--lds_options", "0",
              "1", "--fds_options", "1", "--rrt", "--rrt_from", "self", "--seeds", "0",
              "--store_root", f"{TOOLS_ROOT}/sweep"]
# STS-B in the per-direction layout on phase 11's corpus: 45 iterations,
# one validation check at the end, one stats pass at the rollover of 41
STS_FLAX_BUDGET = ["--val_interval", "45", "--max_vals", "1"]
STS_STEPS = (3, 10, 5)  # the layouts' step windows: warm-up, host-timed, profiled
# phase 19: the STS-B driver with the DeepSeek-V2 encoder at DeepSeek-V2-Lite's
# widths and vocabulary, cut to two layers (the dense one and one MoE layer
# holding experts 0-7 of 64), on phase 11's corpus, with STS_FLAX_BUDGET
STS_MOE_ARGV = ["--data_dir", STS_DIR, "--encoder", "deepseek_v2", "--glove", "0",
                "--num_hidden_layers", "2", "--experts_held", "8", "--fds", "--lds",
                "--reweight", "inverse", *STS_FLAX_BUDGET, "--cache_dir", f"{STS_DIR}/cache"]
# phase 17: the DIR tutorial (a 13 -> 64 -> 64 MLP, FDS on its 64-wide
# hook, 51 buckets; 1,749 rows after its tail subsampling, 13 steps of 128
# an epoch, 15 epochs, calibrating from epoch 1), its notebook, the entry
TUTORIAL_SCRIPT = "imbalanced_regression_tpu_torch/tutorial/tutorial.py"
TUTORIAL = (64, 51)  # (D, B)
TUTORIAL_BATCH = 128  # K1/K2's rows
TUTORIAL_ROWS = 1749  # K3's rows: the stats pass over the whole set
TUTORIAL_EPOCHS = 15
# the tutorial on the card against the same run on the CPU (same weights,
# same permutations): the first epoch's 13 losses (FDS not calibrating
# yet) within 1e-5 relative, the final overall and per-shot MAE after 15
# epochs within 1% relative, the tolerances the CPU test holds the port
# to against JAX (tests/test_torch_tutorial.py); on an H100 the gaps were
# 1.1e-7 and at most 1.7e-7 (float32 throughout, TF32 off)
TUTORIAL_LOSS_RTOL = 1e-5
TUTORIAL_MAE_RTOL = 0.01
# entry() on the card against the CPU: bf16 ResNet-50, as in phase 14 (on
# an H100, 4.95e-3 of the largest magnitude on a seeded batch)
ENTRY_TOL = SERVE_TOL
# phase 18: the graphed step against the eager one at the benchmark cells'
# shapes; steps timed after the bit-equality check (an STS-B epoch is 41)
GRAPH_AGE_ARGV = ["--dataset", "agedb", "--img_size", "224", "--batch_size", "256", "--fds",
                  "--lds", "--reweight", "sqrt_inv", "--save_ckpt", "0", "--device", "cuda"]
GRAPH_STS_RECIPE = {"fds": True, "lds": True, "reweight": "inverse", "device": "cuda",
                    "batch_size": 128}
GRAPH_STS_ROWS, GRAPH_STS_VOCAB = 5249, 12004
GRAPH_TIMED = 41
# the LSTM cell at the STS-B cell's shape: 512 rows (2 columns x 2 directions x
# 128 pairs), 40 steps, H = 1500
LSTM_CELL = (512, 40, 1500)
# the MoE dispatch at the STS-B DeepSeek-V2 cell's layer: 10,240 token
# positions (2 columns x 128 pairs x 40), top-6 of 64 experts, 8 held, D = 2,048
MOE_LAYER = (10240, 6, 64, 8, 2048)
SOURCES = {"calibrate_forward": "fds_kernels.cu", "calibrate_backward": "fds_kernels.cu",
           "segment_moments": "fds_kernels.cu", "segment_moments_v2": "moments_v2.cu",
           "lstm_cell_forward": "lstm_cell.cu", "lstm_cell_backward": "lstm_cell.cu",
           **dict.fromkeys(("moe_dispatch", "moe_dispatch_backward", "moe_combine",
                            "moe_combine_backward"), "moe_dispatch.cu")}
PALLAS = "imbalanced_regression_tpu/ops/pallas_kernels.py"
# the TPU kernel each replaces; the LSTM cell none (the JAX package's cell
# is XLA's, inside ``lax.scan``)
REPLACES = {"calibrate_forward": f"{PALLAS}:208", "calibrate_backward": f"{PALLAS}:236",
            "segment_moments": f"{PALLAS}:50", "segment_moments_v2": f"{PALLAS}:128",
            "lstm_cell_forward": None, "lstm_cell_backward": None,
            **dict.fromkeys(("moe_dispatch", "moe_dispatch_backward", "moe_combine",
                             "moe_combine_backward"))}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean per-call time of ``iters``
    back-to-back calls, by CUDA events (host launch cost included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def graph_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in a CUDA graph and
    replayed, so host launch cost is out of the measurement."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=1, repeats=repeats) / iters


def bound(bytes_moved: float, flops: float, bf16_flops: float = 0.0) -> tuple[float, str]:
    """The least time for the work: the larger of the bytes over the memory
    rate and the operations over their unit's peak (float32 outside the
    tensor cores, bf16 on them; the two units run side by side)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS, bf16_flops / BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def calibrate_inputs(gen: torch.Generator, dev, n: int, d: int, b: int, sts_corners: bool = False):
    """Random FDS statistics with the corner cases of the JAX tests: an
    all-zero v1 row, a zero v1 column, a negative v2, ratios beyond the
    clip range, rows with ok=False and rows with e=-1. ``sts_corners``
    adds the STS-B ones: a bucket no row falls in (``impute_empty`` fills
    such buckets' statistics) and rows of a bucket whose positive v1 sums
    to under 1e-10."""
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    x = r(n, d)
    e = torch.randint(0, b, (n,), generator=gen, device=dev, dtype=torch.int32)
    e[:4] = -1
    e[4:8] = 2  # rows of the all-zero v1 bucket
    ok = torch.rand(n, generator=gen, device=dev) > 0.2
    m1, m2 = r(b, d), r(b, d)
    v1, v2 = u(0.01, 3.0, b, d), u(0.01, 3.0, b, d)
    v1[2] = 0.0
    v1[5, 3] = 0.0
    v2[6, 1] = -1.0
    v2[7, :64] = 100.0
    if sts_corners:
        e[e == b - 1] = b - 2  # bucket b - 1 holds no row
        v1[3] = 1e-15  # v1sum = d * 1e-15 < 1e-10 at d = 12000: rows gated off
        e[8:12] = 3
    return x, e, ok, (m1, v1, m2, v2), v1.sum(1)


def calibrate_bytes(x_elt: int, e, ok, v1sum, d: int, tables: int) -> tuple[float, int]:
    """Bytes the calibrate function must move on these inputs: x in, out,
    e and ok, and for the rows it calibrates the distinct bucket rows of
    ``tables`` [B, D] tables plus their v1sum entries. Returns (bytes,
    calibrated elements)."""
    n, b = e.numel(), v1sum.numel()
    valid = (e >= 0) & (e < b)
    on = valid & ok & (v1sum[e.clamp(min=0).long()] >= 1e-10)
    buckets = torch.unique(e[on]).numel()
    rows_on = int(on.sum())
    nbytes = n * d * x_elt + n * d * 4 + n * 4 + n + buckets * (tables * d * 4 + 4)
    return nbytes, rows_on * d


def timed(kernel, plain, library, nbytes: float, flops: float, err: float, shape: str,
          iters: int = 50, bf16_flops: float = 0.0, graph_iters: int = 20) -> dict:
    return dict(max_abs_err=err, ms=time_ms(kernel, iters), device_ms=graph_ms(kernel, graph_iters),
                plain_ms=time_ms(plain, iters), library_ms=time_ms(library, iters) if library else None,
                bound=bound(nbytes, flops, bf16_flops), bytes=nbytes, shape=shape)


def cold_tables(fn, tables, iters: int = 20):
    """``fn(*tables)`` on distinct copies of the statistics ``tables``,
    one copy a call in turn: enough copies that a turn over them touches
    1.5 times the L2 cache (at most ``MAX_COLD_COPIES``), so each call finds
    its tables out of L2, as in a train step, where a whole forward and
    backward runs between two calibrate calls. The other inputs stay warm,
    as the step leaves them. Returns the callable and the calls a graph
    captures: at least ``iters``, a whole number of turns."""
    nbytes = sum(t.numel() * t.element_size() for t in tables)
    k = min(MAX_COLD_COPIES, math.ceil(1.5 * L2_BYTES / nbytes))
    copies = itertools.cycle([tuple(t.clone() for t in tables) for _ in range(k)])
    return (lambda: fn(*next(copies))), k * math.ceil(iters / k)


def shape_tag(n: int, d: int, b: int) -> str:
    return f"N={n},D={d},B={b}"


def check_calibrate(ck, cal, gen, dev, n: int, d: int, b: int, modes, record: bool,
                    iters: int = 50, sts: bool = False) -> dict:
    """K1 (float32 and bf16 x) and K2 bit-equal to their plain versions at
    ``n`` rows in each of ``modes`` ((mode, clips) pairs), K2 also within
    1e-6 of autograd through the plain K1; with ``record``, their times
    (statistics cold, ``cold_tables``) and bounds in the first mode too.
    ``sts``: the STS-B corner cases."""
    results = {}
    x, e, ok, stats, v1sum = calibrate_inputs(gen, dev, n, d, b, sts_corners=sts)
    # ---- K1 forward, float32 and bf16 input
    for mode, clips in modes:
        for xs in (x, x.to(torch.bfloat16)):
            args = (xs, e, ok, *stats, v1sum, *clips, mode)
            got, want = ck.calibrate_forward(*args), cal.calibrate_indexed(*args)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"K1 calibrate_forward N={n} D={d} mode={mode} x={xs.dtype}: max_abs_err {err:.3e}")
            # IEEE division and square root, unfused mul/add in the plain version's order
            assert torch.equal(got, want), "K1 is not bit-equal to its plain version"
    mode, clips = modes[0]
    if record:
        args = (x, e, ok, *stats, v1sum, *clips, mode)
        nbytes, elems = calibrate_bytes(4, e, ok, v1sum, d, tables=4)
        kernel, graph_iters = cold_tables(
            lambda *t: ck.calibrate_forward(x, e, ok, *t, *clips, mode), (*stats, v1sum))
        plain, _ = cold_tables(lambda *t: cal.calibrate_indexed(x, e, ok, *t, *clips, mode),
                               (*stats, v1sum))
        results["calibrate_forward"] = timed(
            kernel, plain, None, nbytes, 8 * elems,
            max_err(ck.calibrate_forward(*args), cal.calibrate_indexed(*args)),
            shape_tag(n, d, b), iters, graph_iters=graph_iters)

    # ---- K2 backward against autograd of the plain version
    g = torch.randn(n, d, generator=gen, device=dev)
    for mode_, clips_ in modes:
        xg = x.clone().requires_grad_(True)
        out = cal.calibrate_indexed(xg, e, ok, *stats, v1sum, *clips_, mode_)
        (want,) = torch.autograd.grad(out, xg, g)
        got = ck.calibrate_backward(g, e, ok, stats[1], stats[3], v1sum, *clips_, mode_)
        torch.cuda.synchronize()
        log(f"K2 calibrate_backward N={n} D={d} mode={mode_}: max_abs_err {max_err(got, want):.3e}")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        plain = cal.calibrate_indexed_grad(g, e, ok, stats[1], stats[3], v1sum, *clips_, mode_)
        assert torch.equal(got, plain), "K2 is not bit-equal to its plain version"
    if record:
        bargs = (g, e, ok, stats[1], stats[3], v1sum, *clips, mode)
        nbytes, elems = calibrate_bytes(4, e, ok, v1sum, d, tables=2)
        tables = (stats[1], stats[3], v1sum)
        kernel, graph_iters = cold_tables(
            lambda *t: ck.calibrate_backward(g, e, ok, *t, *clips, mode), tables)
        plain, _ = cold_tables(lambda *t: cal.calibrate_indexed_grad(g, e, ok, *t, *clips, mode),
                               tables)
        results["calibrate_backward"] = timed(
            kernel, plain, None, nbytes, 6 * elems,
            max_err(ck.calibrate_backward(*bargs), cal.calibrate_indexed_grad(*bargs)),
            shape_tag(n, d, b), iters, graph_iters=graph_iters)
    return results


def calibrate_regimes(ck, sm: int) -> list:
    """K1/K2's cases at the boundary of ``calibrate_plan``'s two forms of K1
    (K2 runs its direct form at both), as (name, D, B, N, factored): the
    factored form's least rows (plus 5, so no multiple of a block's rows)
    and one row short of them, at D = 128, at D = 130 (the scalar path)
    and at the tutorial's D = 64 (a row tile of 16 threads)."""
    cases = []
    for d, b in ((128, 93), (130, 12), TUTORIAL):
        least = ck.FACTORED_ROWS_PER_BUCKET * b * sm
        cases += [(f"D={d}, factored form", d, b, least + 5, True),
                  (f"D={d}, direct form one row short", d, b, least - 1, False)]
    return cases


def check_calibrate_regimes(ck, cal, gen, dev) -> None:
    """K1 (float32 and bf16 x) and K2 bit-equal to their plain versions in
    both modes at each of ``calibrate_regimes``, with the corner cases of
    ``calibrate_inputs``; the plan checked to take the form named."""
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, d, b, n, factored in calibrate_regimes(ck, sm):
        plan = ck.calibrate_plan(n, d, b, sm)
        assert plan.factored == factored and not ck.calibrate_plan(n, d, b, sm, True).factored, \
            (name, plan)
        x, e, ok, stats, v1sum = calibrate_inputs(gen, dev, n, d, b)
        g = torch.randn(n, d, generator=gen, device=dev)
        for mode, clips in (("nonzero", (0.1, 10.0)), ("positive", (0.5, 2.0))):
            for xs in (x, x.to(torch.bfloat16)):
                args = (xs, e, ok, *stats, v1sum, *clips, mode)
                assert torch.equal(ck.calibrate_forward(*args), cal.calibrate_indexed(*args)), \
                    f"K1 {name} {mode} {xs.dtype}: not bit-equal to its plain version"
            bargs = (g, e, ok, stats[1], stats[3], v1sum, *clips, mode)
            assert torch.equal(ck.calibrate_backward(*bargs), cal.calibrate_indexed_grad(*bargs)), \
                f"K2 {name} {mode}: not bit-equal to its plain version"
        torch.cuda.synchronize()
        log(f"K1/K2 {name}: N={n} D={d} B={b}, plan {plan}: bit-equal to the plain versions "
            f"(both modes, K1 float32 and bf16 x)")


def moments_inputs(gen, dev, n: int, d: int, b: int, empty_bucket: bool = False):
    """Features with a per-column scale (as ``tests/test_pallas.py`` feeds
    the TPU kernel), every 9th row outside the buckets; with
    ``empty_bucket``, no row in the last bucket."""
    scale = 0.1 + 29.9 * torch.rand(1, d, generator=gen, device=dev)
    f = torch.randn(n, d, generator=gen, device=dev) * scale + 1.0
    idx = torch.randint(0, b, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx[::9] = -1
    if empty_bucket:
        idx[idx == b - 1] = b - 2
    return f, idx


def run_idx(gen, dev, n: int, b: int, width: int = DEPTH_HW[1]):
    """Bucket indices in runs along rows of ``width`` pixels, as a depth
    map's rows in NHWC order give: each row a ramp from a random bucket with
    a random slope of at most 0.2 buckets a pixel (runs of 5 or more equal
    buckets), every 97th pixel outside the buckets."""
    rows = -(-n // width)
    start = b * torch.rand(rows, 1, generator=gen, device=dev)
    slope = 0.4 * torch.rand(rows, 1, generator=gen, device=dev) - 0.2
    ramp = start + slope * torch.arange(width, device=dev)
    idx = ramp.floor().clamp(0, b - 1).to(torch.int32).reshape(-1)[:n].contiguous()
    idx[::97] = -1
    return idx


def float64_moments(f, idx, b: int):
    """counts, sums, sums of squares and sums of |f|, in float64."""
    valid = (idx >= 0) & (idx < b)
    fv, iv = f[valid].double(), idx[valid].long()
    zeros = lambda: torch.zeros((b, f.shape[1]), dtype=torch.float64, device=f.device)  # noqa: E731
    count = torch.zeros(b, dtype=torch.float64, device=f.device).index_add_(
        0, iv, torch.ones_like(iv, dtype=torch.float64))
    return (count, zeros().index_add_(0, iv, fv), zeros().index_add_(0, iv, fv * fv),
            zeros().index_add_(0, iv, fv.abs()))


def check_against_float64(name: str, got, ref) -> tuple[float, float]:
    """Counts exact; sums within 1e-5 of the bucket's sum of |f|, sums of
    squares within 1e-5 of its sum of f*f (a float32 sum of n terms is
    within about n * 2^-24 of that, and the row split keeps n to a chunk's
    rows of one bucket). Returns the worst relative errors of the two."""
    count, total, total_sq, total_abs = ref
    c, s, q = got
    assert torch.equal(c.double(), count), f"{name}: counts differ from the float64 reference"
    tiny = torch.finfo(torch.float64).tiny
    rel_s = float(((s.double() - total).abs() / total_abs.clamp(min=tiny)).max())
    rel_q = float(((q.double() - total_sq).abs() / total_sq.clamp(min=tiny)).max())
    assert rel_s <= 1e-5 and rel_q <= 1e-5, f"{name}: relative errors {rel_s:.3e}, {rel_q:.3e}"
    return rel_s, rel_q


def moments_bound(n_valid: int, n: int, d: int, b: int, v2: bool) -> tuple[float, float, float]:
    """(bytes, float32 operations, bf16 tensor-core operations) the moments
    function needs on these inputs: every index and the features of the
    rows inside the buckets in once (a row outside them adds nothing and
    need not be read), the outputs out once; 3 float32 operations per valid
    element for K3; for K4 the split (f * f and four subtractions per
    element) and the one-hot products that the data needs: each valid row's
    six bf16 terms times the one 1 of its one-hot row (a product with a 0
    adds nothing)."""
    nbytes = n_valid * d * 4 + n * 4 + b * 4 + 2 * b * d * 4
    if v2:
        return nbytes, 5 * n_valid * d, 2 * n_valid * 6 * d
    return nbytes, 3 * n_valid * d, 0.0


def library_moments(f, idx, b: int):
    """The same sums by one PyTorch call (``index_add_``, atomics) on
    prepared rows [f, f*f, 1]."""
    valid = (idx >= 0) & (idx < b)
    src = torch.cat([f[valid], f[valid] * f[valid], torch.ones_like(f[valid, :1])], 1)
    tgt = idx[valid].long()
    return lambda: torch.zeros(b, src.shape[1], device=f.device).index_add_(0, tgt, src)


def log_plan(ck, n: int, d: int) -> None:
    plan = ck.moments_plan(n, d, torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"K3 plan at N={n} D={d}: {plan}")


def check_moments(ck, gen, dev, n: int, d: int, b: int, record: bool, iters: int = 50,
                  names=("segment_moments", "segment_moments_v2"),
                  empty_bucket: bool = False) -> dict:
    """The moments kernels ``names`` (K3, K4) against their plain versions
    at ``n`` rows, and two runs bit-identical; with ``record``, their times
    and bounds too (K4's at the age shape are logged only)."""
    f, idx = moments_inputs(gen, dev, n, d, b, empty_bucket)
    log_plan(ck, n, d)
    results = {}
    for name in names:
        kernel, plain = getattr(ck, name), getattr(ck, f"{name}_plain")
        got, again, want = kernel(f, idx, b), kernel(f, idx, b), plain(f, idx, b)
        torch.cuda.synchronize()
        errs = [max_err(a, w) for a, w in zip(got, want)]
        identical = all(torch.equal(a, w) for a, w in zip(got, again))
        log(f"{name} N={n} D={d}: count err {errs[0]:.1e}, sum err {errs[1]:.3e}, "
            f"sumsq err {errs[2]:.3e}, bit-identical across two runs: {identical}")
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)  # counts exact
        # float32 sums in another order than the one-hot matmul: 1e-5 of
        # the largest sum
        for a, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
        assert identical, f"{name} differs between two runs"
        if record:
            n_valid = int((idx >= 0).sum())
            nbytes, flops, bf16 = moments_bound(n_valid, n, d, b, name.endswith("v2"))
            library = library_moments(f, idx, b)
            torch.testing.assert_close(library()[:, :d], want[1], rtol=1e-5,
                                       atol=1e-5 * float(want[1].abs().max()))
            results[name] = timed(lambda k=kernel: k(f, idx, b), lambda p=plain: p(f, idx, b),
                                  library, nbytes, flops, max(errs), shape_tag(n, d, b), iters,
                                  bf16)
    return results


def check_depth_moments(ck, gen, dev) -> dict:
    """K3 and K4 at the NYUD2 shape against a float64 reference, bit-identical
    across two runs, and timed; on a random index and on one in runs."""
    n, (d, b) = N_DEPTH, DEPTH
    f, idx = moments_inputs(gen, dev, n, d, b)
    log_plan(ck, n, d)
    results = {}
    runs = run_idx(gen, dev, n, b)
    for name, idx_ in (("segment_moments", idx), ("segment_moments_v2", idx),
                       ("segment_moments runs", runs), ("segment_moments_v2 runs", runs)):
        kernel, plain = getattr(ck, name.split()[0]), getattr(ck, f"{name.split()[0]}_plain")
        ref = float64_moments(f, idx_, b)
        got, again = kernel(f, idx_, b), kernel(f, idx_, b)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, w) for a, w in zip(got, again))
        rel_s, rel_q = check_against_float64(name, got, ref)
        log(f"{name} N={n} D={d} B={b}: counts exact, sums within {rel_s:.3e} of sum|f|, "
            f"sumsq within {rel_q:.3e} of sum f^2 (float64 reference), bit-identical across two "
            f"runs: {identical}")
        assert identical, f"{name} differs between two runs"
        n_valid = int(((idx_ >= 0) & (idx_ < b)).sum())
        nbytes, flops, bf16 = moments_bound(n_valid, n, d, b, name.split()[0].endswith("v2"))
        err = max(max_err(a, w) for a, w in zip(got, ref[:3]))
        tag = shape_tag(n, d, b) + (",idx=runs" if name.endswith("runs") else "")
        results[name] = timed(lambda k=kernel, i=idx_: k(f, i, b),
                              lambda p=plain, i=idx_: p(f, i, b), library_moments(f, idx_, b),
                              nbytes, flops, err, tag, 10, bf16)
    return results


def log_records(results: dict) -> None:
    for name, r in results.items():
        log(f"{name} {r['shape']}: ms {r['ms']:.4f} (device {r['device_ms']:.4f}), plain_ms "
            f"{r['plain_ms']:.4f}, library_ms {r['library_ms']}, bound_ms {r['bound'][0]:.5f} "
            f"({r['bound'][1]}, {r['bytes']} bytes)")


def graph_floor_ms(dev) -> float:
    """Device time per node of a replayed CUDA graph whose nodes do almost
    nothing (a one-element ``add_``): no kernel timed by ``graph_ms`` can
    show less."""
    x = torch.zeros(1, device=dev)
    floor = graph_ms(lambda: x.add_(1.0))
    log(f"graph-node floor (one-element add_, replayed CUDA graph): {floor:.5f} ms per node")
    return floor


def lstm_cell_bytes(rows: int, hid: int, kind: str) -> int:
    """Bytes one step of the cell must move at T = bf16: the forward reads
    xw_t and hw ([rows, 4H] bf16) and c_{t-1} and writes c_t, h_t (float32
    [rows, H]), h_t in bf16 and, saving (``fwd``, not ``fwd_nosave``), the
    bf16 gates; the backward reads the gates, c_{t-1}, c_t, dh_t, the bf16
    recurrent dh and dc_{t+1} and writes d_gates (bf16) and dc_t."""
    gates, state = rows * 4 * hid * 2, rows * hid * 4
    if kind == "bwd":
        return gates + 3 * state + rows * hid * 2 + state + gates + state
    return 2 * gates + 3 * state + rows * hid * 2 + (gates if kind == "fwd" else 0)


def lstm_cell_phase(ck, dev) -> dict:
    """The LSTM cell kernels at the STS-B cell's shape (``LSTM_CELL``: 2
    columns x 2 directions x 128 pairs = 512 rows, H = 1500, 40 steps,
    bf16): forward with and without the saved gates, and backward, held
    against the plain cell on the card (gates bit-equal, states within
    2e-6 of the largest, gradients within 2^-6), then timed over steps 1..39
    (so each call finds its xw slice out of L2, as the layer's loop does):
    ms by CUDA events, device ms in a replayed graph, the plain cell's ms,
    and ATen's fused cell on bf16 gates of the same shape (the library
    yardstick, never called by the port): ``_thnn_fused_lstm_cell`` beside
    both forwards (it keeps its workspace either way),
    ``_thnn_fused_lstm_cell_backward_impl`` on that call's workspace beside
    the backward. Then one train forward and backward of a 2-layer
    ``FusedBiLSTM`` at full width, and a no-grad forward, counting the cell
    launches. Returns the records by kernel."""
    from imbalanced_regression_tpu_torch.models.bilstm_pair import FusedBiLSTM
    from imbalanced_regression_tpu_torch.ops import lstm_cell

    rows, steps, hid = LSTM_CELL
    gen = torch.Generator(device=dev).manual_seed(22)
    bf = torch.bfloat16
    xw = torch.randn(rows, steps, 4 * hid, generator=gen, device=dev).to(bf)
    hw = torch.randn(rows, 4 * hid, generator=gen, device=dev).to(bf)
    dhs = torch.randn(rows, steps, hid, generator=gen, device=dev)
    dh_rec = torch.randn(rows, hid, generator=gen, device=dev).to(bf)

    # c_all, hs, hprev, gates; c_all drawn, so every step has a c_{t-1}
    kern = (torch.randn(rows, steps, hid, generator=gen, device=dev),
            torch.zeros(rows, steps, hid, device=dev),
            torch.zeros(rows, steps, hid, device=dev, dtype=bf), torch.zeros_like(xw))
    plain = tuple(b.clone() for b in kern)
    for t in (0, 1, steps - 1):
        ck.lstm_cell_forward(xw, hw, *kern, t)
        lstm_cell.lstm_cell_forward_plain(xw, hw, *plain, t)
    torch.cuda.synchronize()
    assert torch.equal(kern[3], plain[3])
    fwd_err = max(max_err(kern[i], plain[i]) / float(plain[i].abs().max()) for i in (0, 1))
    assert fwd_err <= 2e-6, fwd_err
    c_all, hs, hprev, gates = kern
    dk = (torch.randn(rows, hid, generator=gen, device=dev), torch.empty_like(xw))
    dp = (dk[0].clone(), torch.empty_like(xw))
    for t in (steps - 1, steps - 2, 0):
        ck.lstm_cell_backward(gates, c_all, dhs, dh_rec, *dk, t)
        lstm_cell.lstm_cell_backward_plain(gates, c_all, dhs, dh_rec, *dp, t)
    torch.cuda.synchronize()
    bwd_err = max(max_err(dk[0], dp[0]) / float(dp[0].abs().max()),
                  max_err(dk[1], dp[1]) / float(dp[1].abs().max()))
    log(f"lstm cell: forward largest relative diff {fwd_err!r}, backward {bwd_err!r}")
    assert bwd_err <= 2.0**-6, bwd_err

    turn = itertools.cycle(range(1, steps - 1))
    ig = torch.randn(steps, rows, 4 * hid, generator=gen, device=dev).to(bf)
    cx = torch.randn(rows, hid, generator=gen, device=dev).to(bf)
    aten = torch.ops.aten
    library_fwd = lambda: aten._thnn_fused_lstm_cell(ig[next(turn)], hw, cx)  # noqa: E731
    # (cy, workspace) of each step's library forward, for its backward
    saved = [aten._thnn_fused_lstm_cell(ig[t], hw, cx)[1:] for t in range(steps)]
    d_hy, d_cy = dh_rec, torch.randn(rows, hid, generator=gen, device=dev).to(bf)
    cases = {
        "lstm_cell_forward": (lambda: ck.lstm_cell_forward(xw, hw, *kern, next(turn)),
                              lambda: lstm_cell.lstm_cell_forward_plain(xw, hw, *plain, next(turn)),
                              library_fwd, "fwd", fwd_err),
        "lstm_cell_forward nosave": (
            lambda: ck.lstm_cell_forward(xw, hw, *kern[:3], None, next(turn)),
            lambda: lstm_cell.lstm_cell_forward_plain(xw, hw, *plain[:3], None, next(turn)),
            library_fwd, "fwd_nosave", fwd_err),
        "lstm_cell_backward": (
            lambda: ck.lstm_cell_backward(gates, c_all, dhs, dh_rec, *dk, next(turn)),
            lambda: lstm_cell.lstm_cell_backward_plain(gates, c_all, dhs, dh_rec, *dp, next(turn)),
            lambda: aten._thnn_fused_lstm_cell_backward_impl(d_hy, d_cy, cx, *saved[next(turn)],
                                                             False),
            "bwd", bwd_err)}
    records = {}
    for name, (kernel, plain_fn, library, kind, err) in cases.items():
        nbytes = lstm_cell_bytes(rows, hid, kind)
        records[name] = r = timed(kernel, plain_fn, library, nbytes, 0.0, err,
                                  f"rows={rows},H={hid},steps={steps},bf16", iters=steps - 2,
                                  graph_iters=steps - 2)
        log(f"{name}: {r['ms']:.5f} ms, device {r['device_ms']:.5f} ms, bound {r['bound'][0]:.5f} "
            f"ms ({nbytes / 1e6:.3f} MB), {100 * r['bound'][0] / r['device_ms']:.1f}% of it; "
            f"plain {r['plain_ms']:.5f} ms, library {r['library_ms']}")

    mod = FusedBiLSTM(300, hid, 2, bf).to(dev)
    x = torch.randn(rows // 2, steps, 300, generator=gen, device=dev).to(bf)
    lengths = torch.randint(5, steps + 1, (rows // 2,), generator=gen, device=dev)
    ck.reset_launch_counts()
    mod(x, lengths).float().square().sum().backward()
    torch.cuda.synchronize()
    train = (ck.lstm_cell_forward.launches, ck.lstm_cell_backward.launches)
    ck.reset_launch_counts()
    with torch.no_grad():
        mod(x, lengths)
    torch.cuda.synchronize()
    stats = (ck.lstm_cell_forward.launches, ck.lstm_cell_backward.launches)
    ck.reset_launch_counts()
    log(f"lstm cell launches: a train forward and backward {train}, a no-grad forward {stats}")
    assert train == (2 * steps, 2 * steps) and stats == (2 * steps, 0), (train, stats)
    return records


def moe_dispatch_bytes(tokens: int, k: int, d: int, rows: int, touched: int, kind: str) -> int:
    """Bytes one call must move in bf16: the dispatch reads the int64
    choices and the touched tokens' rows and writes each slot's row, the
    offsets and the routed rows; the combine reads the routed rows and the
    slots' rows and weights and writes float32 [T, D]; its backward reads
    the float32 gradient, the routed rows and the slots and writes the
    rows' and the weights' gradients; the dispatch's backward reads the
    rows' gradient and the slots and writes [T, D]."""
    slots, e = tokens * k, 2
    return {"dispatch": slots * 12 + (touched + rows) * d * e + slots * 4,
            "combine": rows * d * e + slots * 8 + tokens * d * 4,
            "combine_bwd": tokens * d * 4 + 2 * rows * d * e + slots * 12,
            "dispatch_bwd": rows * d * e + slots * 4 + tokens * d * e}[kind]


def moe_dispatch_phase(ck, dev) -> dict:
    """The MoE dispatch and combine kernels at the DeepSeek-V2 cell's layer
    (``MOE_LAYER``, bf16, the router's top-6 of random logits), held
    against their plain versions run on the card: slots, offsets, counters
    and the routed rows equal, the combine and both backwards bit for bit,
    the weights' gradient within 1e-5 of the largest; then timed (ms by
    CUDA events, device ms in a replayed graph, the plain version's ms)
    beside the least time of their bytes. Returns the records by kernel."""
    from imbalanced_regression_tpu_torch.ops import moe_dispatch as md

    tokens, k, experts, held, d = MOE_LAYER
    gen = torch.Generator(device=dev).manual_seed(23)
    w, idx = torch.randn(tokens, experts, generator=gen, device=dev).softmax(-1).topk(k, dim=-1)
    x = torch.randn(tokens, d, generator=gen, device=dev).to(torch.bfloat16)
    counters = [torch.zeros(held, dtype=torch.int64, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev)]
    plain_counters = [c.clone() for c in counters]
    xs, pos, offs = ck.moe_dispatch(x, idx, 0, held, *counters)
    pxs, ppos, poffs = md.moe_dispatch_plain(x, idx, 0, held, *plain_counters)
    rows, touched = int(poffs[-1]), int(plain_counters[1])
    assert torch.equal(pos, ppos) and torch.equal(offs, poffs)
    assert all(torch.equal(a, b) for a, b in zip(counters, plain_counters))
    assert torch.equal(xs[:rows], pxs[:rows])
    y = torch.randn(xs.shape, generator=gen, device=dev).to(torch.bfloat16)
    dout = torch.randn(tokens, d, generator=gen, device=dev)
    assert torch.equal(ck.moe_combine(y, w, pos), md.moe_combine_plain(y, w, pos))
    assert torch.equal(ck.moe_dispatch_backward(y, pos), md.moe_dispatch_backward_plain(y, pos))
    dy, dw = ck.moe_combine_backward(dout, y, w, pos)
    pdy, pdw = md.moe_combine_backward_plain(dout, y, w, pos)
    torch.cuda.synchronize()
    assert torch.equal(dy[:rows], pdy[:rows])
    dw_err = max_err(dw, pdw) / float(pdw.abs().max())
    assert dw_err <= 1e-5, dw_err
    log(f"moe dispatch: {rows} routed rows of {tokens * k} slots ({touched} tokens touched), "
        f"per expert {torch.diff(offs, prepend=offs.new_zeros(1)).tolist()}; combine's weight "
        f"gradient largest relative diff {dw_err!r}")
    cases = {
        "moe_dispatch": (lambda: ck.moe_dispatch(x, idx, 0, held, *counters),
                         lambda: md.moe_dispatch_plain(x, idx, 0, held, *plain_counters),
                         "dispatch", 0.0),
        "moe_combine": (lambda: ck.moe_combine(y, w, pos), lambda: md.moe_combine_plain(y, w, pos),
                        "combine", 0.0),
        "moe_combine_backward": (lambda: ck.moe_combine_backward(dout, y, w, pos),
                                 lambda: md.moe_combine_backward_plain(dout, y, w, pos),
                                 "combine_bwd", dw_err),
        "moe_dispatch_backward": (lambda: ck.moe_dispatch_backward(y, pos),
                                  lambda: md.moe_dispatch_backward_plain(y, pos), "dispatch_bwd",
                                  0.0)}
    records = {}
    for name, (kernel, plain_fn, kind, err) in cases.items():
        nbytes = moe_dispatch_bytes(tokens, k, d, rows, touched, kind)
        records[name] = r = timed(kernel, plain_fn, None, nbytes, 0.0, err,
                                  f"T={tokens},K={k},E={held}/{experts},D={d},bf16", iters=20)
        log(f"{name}: {r['ms']:.5f} ms, device {r['device_ms']:.5f} ms, bound {r['bound'][0]:.5f} "
            f"ms ({nbytes / 1e6:.3f} MB), {100 * r['bound'][0] / r['device_ms']:.1f}% of it; "
            f"plain {r['plain_ms']:.5f} ms")
    return records


def kernel_phase(ck, cal, dev) -> tuple[dict, dict, dict, dict, dict]:
    """Every kernel against its plain version at the age path's batch
    (N_MAIN rows, where the age records are taken), K1/K2 at the bench's
    N = 128 (timed: the bench records), K3/K4 at N = 128 and 8192; then at
    the NYUD2 shape; then K1, K2 and K3 at the STS-B shape and at the
    AgeDB-DIR batch. Returns the age, bench, depth, STS-B and AgeDB
    records."""
    gen = torch.Generator(device=dev).manual_seed(0)
    d, b = AGE
    age, bench = {}, {}
    for n, records in ((N_MAIN, age), (BENCH_BATCH, bench)):
        records.update(check_calibrate(ck, cal, gen, dev, n, d, b,
                                       [("nonzero", (0.1, 10.0)), ("positive", (0.5, 2.0))],
                                       record=True))
    for n in (N_MAIN, 128, 8192):
        age.update(check_moments(ck, gen, dev, n, d, b, record=n == N_MAIN))
    log_records(age)
    log_records(bench)
    age.pop("segment_moments_v2")  # not on the age path: logged, not a record
    depth = check_calibrate(ck, cal, gen, dev, N_DEPTH, *DEPTH, [("positive", (0.2, 5.0))],
                            record=True, iters=10)
    depth.update(check_depth_moments(ck, gen, dev))
    log_records(depth)
    sts = check_calibrate(ck, cal, gen, dev, STS_BATCH, *STS, [("positive", (0.5, 2.0))],
                          record=True, sts=True)
    check_calibrate_regimes(ck, cal, gen, dev)
    sts.update(check_moments(ck, gen, dev, STS_BATCH, *STS, record=True,
                             names=("segment_moments",), empty_bucket=True))
    assert ck.moments_plan(STS_BATCH, STS[0], torch.cuda.get_device_properties(0)
                           .multi_processor_count).kernel == "short"
    log_records(sts)
    agedb = check_calibrate(ck, cal, gen, dev, AGEDB_BATCH, *AGEDB, [("nonzero", (0.1, 10.0))],
                            record=True)
    agedb.update(check_moments(ck, gen, dev, AGEDB_BATCH, *AGEDB, record=True,
                               names=("segment_moments",)))
    assert ck.moments_plan(AGEDB_BATCH, AGEDB[0], torch.cuda.get_device_properties(0)
                           .multi_processor_count).kernel == "short"
    log_records(agedb)
    return age, bench, depth, sts, agedb


def main_path_phase(ck) -> dict:
    from imbalanced_regression_tpu_torch.tasks import age

    ck.reset_launch_counts()
    t0 = time.time()
    result = age.main(MAIN_ARGV)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}
    log(f"age path: {time.time() - t0:.1f}s, kernel launches {launches}")
    for h in result["history"]:
        log(f"epoch {h['epoch']}: train_loss {h['train_loss']:.4f} val_l1 {h['val_loss_l1']:.4f} "
            f"img/s {h['images_per_sec']:.1f} (train {h['train_seconds']:.2f}s, fds pass "
            f"{h['fds_pass_seconds']:.2f}s) calibrating {h['fds_calibrating']}")
    losses = [h["train_loss"] for h in result["history"]]
    assert all(math.isfinite(v) for v in losses), losses
    assert all(math.isfinite(v) for v in result["test"].values()), result["test"]
    for name in ("calibrate_forward", "calibrate_backward", "segment_moments"):
        assert launches[name] > 0, f"{name} was not launched on the age path"
    log(f"age path: K3 launches by kernel {dict(ck.segment_moments.kernels)}")
    assert ck.segment_moments.kernels == {"short": launches["segment_moments"]}
    assert result["history"][-1]["fds_calibrating"], "the last epoch calibrated with fds_init stats"
    fds = result["final_fds"]
    assert (fds.running_var_last_epoch != 1).any() and (fds.smoothed_mean_last_epoch != 0).any()
    return launches


def depth_path_phase(ck) -> tuple[dict, dict]:
    """The NYUD2 train path at full width: ResNet-50 encoder, the reference
    decoder widths, bf16, 228x304 images, batch 32."""
    from imbalanced_regression_tpu_torch.tasks import nyud2

    ck.reset_launch_counts()
    t0 = time.time()
    result = nyud2.main(DEPTH_ARGV)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}
    log(f"depth path: {time.time() - t0:.1f}s, kernel launches {launches}")
    for h in result["history"]:
        log(f"epoch {h['epoch']}: train_loss {h['train_loss']:.4f} test_rmse {h['test_rmse']:.4f} "
            f"img/s {h['images_per_sec']:.2f} (train {h['train_seconds']:.3f}s, fds pass "
            f"{h['fds_pass_seconds']:.3f}s) calibrating {h['fds_calibrating']}")
    assert all(math.isfinite(h["train_loss"]) and math.isfinite(h["test_rmse"])
               for h in result["history"]), result["history"]
    assert math.isfinite(result["best_rmse"]), result["best_rmse"]
    for name in ("calibrate_forward", "calibrate_backward", "segment_moments"):
        assert launches[name] > 0, f"{name} was not launched on the depth path"
    log(f"depth path: K3 launches by kernel {dict(ck.segment_moments.kernels)}")
    assert ck.segment_moments.kernels == {"split": launches["segment_moments"]}
    assert result["history"][-1]["fds_calibrating"], "the last epoch calibrated with fds_init stats"
    fds = result["state"].fds
    assert (fds.running_var_last_epoch != 1).any() and (fds.smoothed_mean_last_epoch != 0).any()
    return launches, result


def depth_stats_phase(ck, result) -> tuple[dict, dict]:
    """One stats-pass batch of the trained depth model (train-mode backbone,
    no_grad, the photometric augment); its encodings through
    ``fds_bucket_moments`` with K3 and with K4, held against a float64
    reference and each other, then timed on them. Returns the launches of
    this step and the two kernels' records on these encodings."""
    from imbalanced_regression_tpu_torch.data.batching import batch_iterator
    from imbalanced_regression_tpu_torch.fds import fds_bucket_moments
    from imbalanced_regression_tpu_torch.ops.binning import bin_index_depth
    from imbalanced_regression_tpu_torch.tasks import nyud2

    trainer, state = result["trainer"], result["state"]
    cfg = trainer.fds_config
    _, fds_subset, _ = nyud2.build_data(nyud2.parse_nyud_config(DEPTH_ARGV))
    batch = next(batch_iterator(fds_subset, DEPTH_BATCH, shuffle=False))
    dev = trainer.device
    with torch.no_grad():
        state.backbone.train()
        images = torch.as_tensor(batch["input"]).to(dev)
        target = torch.as_tensor(batch["target"]).to(dev)
        enc = state.backbone(trainer.train_augment(images, torch.Generator(device=dev).manual_seed(0)))
        assert enc.shape == (DEPTH_BATCH, *DEPTH_HW, DEPTH[0]) and enc.is_contiguous(), enc.shape
        ck.reset_launch_counts()
        m3 = fds_bucket_moments(cfg, enc, target)
        m4 = fds_bucket_moments(cfg, enc, target, use_kernel="v2")
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}
    log(f"depth stats-pass encodings {tuple(enc.shape)}: launches {launches}")
    assert launches["segment_moments"] == 1 and launches["segment_moments_v2"] == 1, launches
    assert ck.segment_moments.kernels == {"split": 1}, ck.segment_moments.kernels
    idx = bin_index_depth(target.reshape(-1), cfg.bucket_num, cfg.bucket_start) - cfg.bucket_start
    rows = enc.reshape(-1, cfg.feature_dim)
    ref = float64_moments(rows, idx, cfg.num_buckets)
    for name, m in (("K3", m3), ("K4", m4)):
        rel_s, rel_q = check_against_float64(name, (m.count, m.total, m.total_sq), ref)
        log(f"{name} on the stats-pass encodings: counts exact ({int(m.count.sum())} pixels in "
            f"{int((m.count > 0).sum())} buckets), sums within {rel_s:.3e} of sum|f|, sumsq within "
            f"{rel_q:.3e} of sum f^2")
    # both within 1e-5 of the float64 sums, so within 2e-5 of each other
    assert torch.equal(m3.count, m4.count)
    assert bool(((m3.total - m4.total).abs().double() <= 2e-5 * ref[3]).all())
    assert bool(((m3.total_sq - m4.total_sq).abs().double() <= 2e-5 * ref[2]).all())
    n, (d, b) = rows.shape[0], DEPTH
    assert (rows.shape[1], cfg.num_buckets) == DEPTH, (rows.shape, cfg.num_buckets)
    n_valid = int(((idx >= 0) & (idx < b)).sum())
    records = {}
    for name, m in (("segment_moments", m3), ("segment_moments_v2", m4)):
        kernel, plain = getattr(ck, name), getattr(ck, f"{name}_plain")
        nbytes, flops, bf16 = moments_bound(n_valid, n, d, b, name.endswith("v2"))
        err = max(max_err(a, w) for a, w in zip((m.count, m.total, m.total_sq), ref[:3]))
        records[f"{name} encodings"] = timed(
            lambda k=kernel: k(rows, idx, b), lambda p=plain: p(rows, idx, b),
            library_moments(rows, idx, b), nbytes, flops, err,
            shape_tag(n, d, b) + ",idx=stats-pass encodings", 10, bf16)
    log_records(records)
    return launches, records


def resize_run(resize, x, g):
    """(output, gradient in x) of ``resize`` on ``x`` with cotangent ``g``."""
    xg = x.detach().requires_grad_(True)
    y = resize(xg)
    (gx,) = torch.autograd.grad(y, xg, g)
    return y.detach(), gx


def resize_phase(dev) -> None:
    """The depth decoder's bf16 resize (``_resize_bilinear``): output and
    gradient against float64 at 8x10 -> 114x152 (the largest factor of the
    decoder), within ``RESIZE_TOL`` of the largest magnitude, with
    ``F.interpolate``'s bf16 errors logged beside; then forward + backward
    timed at ``mff_up[3]``'s shape (batch 32, 2048 channels) against
    ``F.interpolate`` in bf16 and under bf16 autocast (which runs it in
    float32)."""
    import torch.nn.functional as F

    from imbalanced_regression_tpu_torch.models.depth_encdec import _resize_bilinear

    size = DEPTH_HW
    ours = lambda a: _resize_bilinear(a, size)  # noqa: E731
    interp = lambda a: F.interpolate(a, size=size, mode="bilinear", align_corners=False)  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = lambda *s: torch.randn(*s, generator=gen, device=dev).to(  # noqa: E731
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x, g = bf16(4, 256, 8, 10), bf16(4, 256, *size)
    want = resize_run(interp, x.double(), g.double())
    errs = {}
    for name, fn in (("bilinear matmuls", ours), ("F.interpolate", interp)):
        got = resize_run(fn, x, g)
        assert all(t.dtype == torch.bfloat16 for t in got), [t.dtype for t in got]
        errs[name] = [max_err(a, w) / float(w.abs().max()) for a, w in zip(got, want)]
        log(f"bf16 resize 8x10->{size[0]}x{size[1]} by {name}: output within {errs[name][0]:.3e}, "
            f"gradient within {errs[name][1]:.3e} of the largest float64 magnitude")
    assert max(errs["bilinear matmuls"]) <= RESIZE_TOL, errs

    x, g = bf16(DEPTH_BATCH, 2048, 8, 10), bf16(DEPTH_BATCH, 2048, *size)

    def autocast_interp(a):
        with torch.autocast(device_type="cuda", dtype=torch.bfloat16):
            return interp(a)

    times = {name: time_ms(lambda fn=fn: resize_run(fn, x, g), iters=5)
             for name, fn in (("bilinear matmuls (bf16)", ours), ("F.interpolate bf16", interp),
                              ("F.interpolate under autocast (float32)", autocast_interp))}
    log(f"resize + gradient {tuple(x.shape)} -> {size}, ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))


class Killed(Exception):
    """Stands for the process dying right after a checkpoint was written."""


def launch_counts(ck) -> dict:
    return {fn.__name__: fn.launches for fn in ck.KERNEL_WRAPPERS}


def launches_of(**counts) -> dict:
    """A launch count for each wrapper of ``ck.KERNEL_WRAPPERS``: those of
    ``counts``, 0 for the others (the LSTM cell's, on every path but the
    fused STS-B BiLSTM)."""
    from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck

    names = [fn.__name__ for fn in ck.KERNEL_WRAPPERS]
    assert set(counts) <= set(names), counts
    return {name: counts.get(name, 0) for name in names}


def sts_forwards(cfg, run: dict) -> int:
    """The encoder forwards of the STS-B run ``run`` (a result of
    ``stsb.main``) under ``cfg``: one in each train step, each stats-pass
    batch (the train split's drop-last batches) and each evaluation batch
    (the validation split at each check, the test split once)."""
    from imbalanced_regression_tpu_torch.data.stsb import load_stsb_datasets

    train, val, test, _, _ = load_stsb_datasets(cfg.data_dir, cfg)
    batches = lambda split: -(-len(split["target"]) // cfg.batch_size)  # noqa: E731
    return (run["iterations"]
            + len(run["stats_pass_seconds"]) * (len(train["target"]) // cfg.batch_size)
            + len(run["val_history"]) * batches(val) + batches(test))


def sts_cell_launches(argv: list, run: dict) -> dict:
    """The LSTM cell kernels' launches of the STS-B run ``run`` (a result of
    ``stsb.main(argv)``, in the fused layout): a BiLSTM forward launches
    ``n_layers_enc x max_seq_len`` forward cells (both directions are rows
    of one batch, padded to ``max_seq_len``), a train step as many backward
    ones besides (:func:`sts_forwards`)."""
    from imbalanced_regression_tpu_torch.tasks import stsb

    cfg = stsb.parse_sts_config(argv)
    per = cfg.n_layers_enc * cfg.max_seq_len
    return {"lstm_cell_forward": per * sts_forwards(cfg, run),
            "lstm_cell_backward": per * run["iterations"]}


def sts_moe_launches(argv: list, run: dict) -> dict:
    """The dispatch kernels' launches of the STS-B run ``run`` with the
    ``deepseek_v2`` encoder: each MoE layer's forward launches the route
    and the gather (``moe_dispatch``, two kernels) and ``moe_combine``, a
    train step's backward ``moe_combine_backward`` and
    ``moe_dispatch_backward`` once a layer besides (:func:`sts_forwards`)."""
    from imbalanced_regression_tpu_torch.tasks import stsb

    cfg = stsb.parse_sts_config(argv)
    layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
    forwards = sts_forwards(cfg, run)
    return {"moe_dispatch": 2 * layers * forwards, "moe_combine": layers * forwards,
            "moe_combine_backward": layers * run["iterations"],
            "moe_dispatch_backward": layers * run["iterations"]}


def add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in more.items()}


@contextlib.contextmanager
def cudnn_determinism(on: bool):
    """``cudnn.deterministic = on`` with ``benchmark`` off, restored after;
    ``tasks/age.py`` and ``tasks/nyud2.py`` set neither."""
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = on, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


def store_of(config) -> str:
    return os.path.join(config.store_root, config.derived_store_name())


def with_root(argv: list, root: str) -> list:
    shutil.rmtree(root, ignore_errors=True)
    return argv + ["--store_root", root]


def payload_diffs(a, b, path: str = "") -> list:
    """The paths at which two checkpoint payloads differ (tensors bit for
    bit, everything else by ==)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path} keys"]
        return [d for k in a for d in payload_diffs(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in payload_diffs(x, y, f"{path}[{i}]")]
    if torch.is_tensor(a):
        return [] if a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b) else [path]
    return [] if a == b or (a != a and b != b) else [path]  # a != a: NaN


def killed_and_resumed(ck, module, argv: list, store: str, kill_at: int = 2):
    """Run ``module.main(argv)`` until its ``kill_at``-th checkpoint save has
    been written and die there, then resume with ``--resume``. Returns the
    resumed run's result and the launches of the two runs, each counted
    from 0."""
    real_save = module.save_checkpoint
    calls = 0

    def dying_save(*args, **kwargs):
        nonlocal calls
        real_save(*args, **kwargs)
        calls += 1
        if calls == kill_at:
            raise Killed

    module.save_checkpoint = dying_save
    ck.reset_launch_counts()
    try:
        module.main(argv)
        raise AssertionError("the run was not killed")
    except Killed:
        pass
    finally:
        module.save_checkpoint = real_save
    killed = launch_counts(ck)
    ck.reset_launch_counts()
    result = module.main(argv + ["--resume", store])
    torch.cuda.synchronize()
    return result, killed, launch_counts(ck)


def resumed_equal(full: dict, resumed: dict, keys, full_store: str, resumed_store: str) -> list:
    """What differs between an uninterrupted and a resumed run: result
    entries ``keys`` and the two checkpoints."""
    from imbalanced_regression_tpu_torch.utils.checkpoint import read_checkpoint

    diffs = [k for k in keys if payload_diffs(full[k], resumed[k])]
    for which in ("latest", "best"):
        diffs += payload_diffs(read_checkpoint(full_store, which),
                               read_checkpoint(resumed_store, which), which)
    return diffs


def age_resume_phase(ck) -> tuple[dict, str]:
    """Phase 8. Returns the launches of the asserted runs (uninterrupted,
    killed and resumed, all under ``cudnn.deterministic``) and the store of
    the uninterrupted one (RRT's stage 1)."""
    from imbalanced_regression_tpu_torch.tasks import age
    from imbalanced_regression_tpu_torch.utils.checkpoint import (
        checkpoint_path, restore_checkpoint, save_checkpoint, state_byte_size)
    from imbalanced_regression_tpu_torch.utils.config import parse_config

    launches, stage1 = {}, None
    for deterministic in (True, False):
        tag = "deterministic" if deterministic else "default"
        full_argv = with_root(AGE_RESUME_ARGV, f"{RESUME_ROOT}/age_{tag}_full")
        resumed_argv = with_root(AGE_RESUME_ARGV, f"{RESUME_ROOT}/age_{tag}_resumed")
        full_store = store_of(parse_config(full_argv))
        resumed_store = store_of(parse_config(resumed_argv))
        with cudnn_determinism(deterministic):
            t0 = time.time()
            ck.reset_launch_counts()
            full = age.main(full_argv)
            torch.cuda.synchronize()
            full_launches = launch_counts(ck)
            resumed, killed, resumed_launches = killed_and_resumed(ck, age, resumed_argv,
                                                                   resumed_store)
        diffs = resumed_equal(full, resumed, ("test", "shots", "best_loss"), full_store,
                              resumed_store)
        log(f"age resume, cudnn.deterministic={deterministic}: {time.time() - t0:.1f}s for the "
            f"three runs; uninterrupted test {full['test']}, resumed test {resumed['test']}; "
            f"bit-equal: {not diffs}" + (f" (differs: {diffs[:8]})" if diffs else ""))
        log(f"  launches: uninterrupted {full_launches}, killed {killed}, resumed "
            f"{resumed_launches}")
        if not deterministic:
            break
        assert not diffs, f"the resumed age run differs from the uninterrupted one: {diffs[:8]}"
        for name in ("calibrate_forward", "calibrate_backward", "segment_moments"):
            assert resumed_launches[name] > 0, f"{name} was not launched on the resumed age run"
        for counts in (full_launches, killed, resumed_launches):
            launches = add_counts(launches, counts)
        stage1 = full_store
        # the checkpoint of the trained ResNet-50 + Adam + FDS state
        state, tmp = full["state"], f"{RESUME_ROOT}/timing"
        saves, restores = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(tmp, state, 2, full["best_loss"], is_best=False)
            saves.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            restore_checkpoint(tmp, state, "latest")
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - t0)
        log(f"age checkpoint: {os.path.getsize(checkpoint_path(tmp, 'latest'))} bytes on disk "
            f"({state_byte_size(state)} bytes of tensors); save s {saves}, restore s {restores}")
        shutil.rmtree(tmp)
        shutil.rmtree(f"{RESUME_ROOT}/age_{tag}_resumed")
    shutil.rmtree(f"{RESUME_ROOT}/age_default_full", ignore_errors=True)
    shutil.rmtree(f"{RESUME_ROOT}/age_default_resumed", ignore_errors=True)
    return launches, stage1


def rrt_phase(ck, stage1: str) -> dict:
    """Phase 9: RRT stage 2 on the phase-8 store, then ``--evaluate`` of its
    own store. Returns the stage-2 launches."""
    from imbalanced_regression_tpu_torch.tasks import age
    from imbalanced_regression_tpu_torch.utils.checkpoint import read_checkpoint
    from imbalanced_regression_tpu_torch.utils.config import parse_config

    argv = with_root(RRT_ARGV + ["--pretrained", stage1], f"{RESUME_ROOT}/rrt")
    store = store_of(parse_config(argv))
    real_load = age.load_backbone_params
    loaded = {}

    def recording_load(*args, **kwargs):
        state = real_load(*args, **kwargs)
        loaded["head"] = {k: v.clone() for k, v in state.head.state_dict().items()}
        loaded["fds"] = state.fds
        return state

    age.load_backbone_params = recording_load
    try:
        with cudnn_determinism(True):
            ck.reset_launch_counts()
            t0 = time.time()
            result = age.main(argv)
            torch.cuda.synchronize()
            launches = launch_counts(ck)
            evaluated = age.main(argv + ["--evaluate", "--resume", store])
    finally:
        age.load_backbone_params = real_load
    log(f"RRT stage 2: {time.time() - t0:.1f}s with the evaluation, launches {launches}")
    for h in result["history"]:
        log(f"epoch {h['epoch']}: train_loss {h['train_loss']:.4f} val_l1 {h['val_loss_l1']:.4f} "
            f"calibrating {h['fds_calibrating']}")
    assert all(math.isfinite(h["train_loss"]) for h in result["history"]), result["history"]
    best1 = read_checkpoint(stage1, "best")
    weights = [k for k, _ in result["state"].backbone.named_parameters()]
    for which in ("latest", "best"):
        stage2 = read_checkpoint(store, which)
        changed = [k for k in weights
                   if not torch.equal(stage2["backbone"][k], best1["backbone"][k])]
        assert not changed, f"RRT stage 2 ({which}) moved backbone weights: {changed[:5]}"
    head = result["state"].head.state_dict()
    assert not any(torch.equal(head[k], v.to(head[k].device)) for k, v in loaded["head"].items()), \
        "the head did not move"
    snap, final = loaded["fds"], result["final_fds"]
    assert (snap.running_var_last_epoch != 1).any(), "stage 1's best holds no FDS snapshot"
    assert result["history"][1]["fds_calibrating"], "epoch 1 did not calibrate"
    for f in ("running_mean_last_epoch", "running_var_last_epoch", "smoothed_mean_last_epoch",
              "smoothed_var_last_epoch"):
        assert torch.equal(getattr(final, f), getattr(snap, f)), f"{f} is not the restored snapshot"
    log("RRT stage 2: backbone weights bit-equal to stage 1's best, head moved, epoch 1 "
        "calibrated with the restored snapshot")
    assert launches["calibrate_forward"] > 0 and launches["segment_moments"] > 0, launches
    assert launches["calibrate_backward"] == 0, f"K2 launched under --retrain_fc: {launches}"
    diffs = payload_diffs(result["test"], evaluated["test"])
    log(f"--evaluate of the stage-2 store: test {evaluated['test']} (stage 2's own "
        f"{result['test']}); equal: {not diffs}")
    assert not diffs, diffs
    shutil.rmtree(f"{RESUME_ROOT}/rrt")
    return launches


def depth_resume_phase(ck) -> tuple[dict, str]:
    """Phase 10. Returns the launches of its three runs and the store of
    the uninterrupted one."""
    from imbalanced_regression_tpu_torch.tasks import nyud2
    from imbalanced_regression_tpu_torch.utils.checkpoint import checkpoint_path

    full_argv = with_root(DEPTH_RESUME_ARGV, f"{RESUME_ROOT}/depth_full")
    resumed_argv = with_root(DEPTH_RESUME_ARGV, f"{RESUME_ROOT}/depth_resumed")
    full_store = store_of(nyud2.parse_nyud_config(full_argv))
    resumed_store = store_of(nyud2.parse_nyud_config(resumed_argv))
    with cudnn_determinism(True):
        t0 = time.time()
        ck.reset_launch_counts()
        full = nyud2.main(full_argv)
        torch.cuda.synchronize()
        full_launches = launch_counts(ck)
        resumed, killed, resumed_launches = killed_and_resumed(ck, nyud2, resumed_argv,
                                                               resumed_store)
    diffs = resumed_equal(full, resumed, ("test", "best_rmse", "best_epoch"), full_store,
                          resumed_store)
    log(f"depth resume: {time.time() - t0:.1f}s for the three runs; uninterrupted RMSE "
        f"{full['test']['overall']['RMSE']:.6f} best epoch {full['best_epoch']}, resumed "
        f"{resumed['test']['overall']['RMSE']:.6f} best epoch {resumed['best_epoch']}; bit-equal: "
        f"{not diffs}" + (f" (differs: {diffs[:8]})" if diffs else ""))
    log(f"  launches: uninterrupted {full_launches}, killed {killed}, resumed {resumed_launches}")
    log(f"depth checkpoint: {os.path.getsize(checkpoint_path(full_store, 'latest'))} bytes on disk")
    assert not diffs, f"the resumed depth run differs from the uninterrupted one: {diffs[:8]}"
    for name in ("calibrate_forward", "calibrate_backward", "segment_moments"):
        assert resumed_launches[name] > 0, f"{name} was not launched on the resumed depth run"
    shutil.rmtree(f"{RESUME_ROOT}/depth_resumed")  # the uninterrupted store serves in phase 14
    return add_counts(add_counts(full_launches, killed), resumed_launches), full_store


def write_sts_corpus(root: str = STS_DIR, seed: int = 0) -> None:
    """A synthetic corpus in the GLUE STS-B layout (10 tab-separated
    columns, sentence 1, sentence 2 and score at 7, 8, 9, one header row)
    at ``STS_SPLITS``' sizes, and a 300-d GloVe-format text file of random
    vectors for 90% of the words, all from ``seed``. Sentences are 5-30
    made-up words drawn by a Zipf law over ``STS_VOCAB`` words, with commas
    and a final period (the longest pass 40 tokens); sentence 2 keeps a
    share score / 5 of sentence 1's words. Scores are 5 * Beta(2, 5): the
    top buckets stay empty, and so does [2.5, 2.6), whose scores move up."""
    import numpy as np

    rng = np.random.default_rng(seed)
    consonants, vowels = "bcdfghjklmnprstvz", "aeiou"
    words = set()
    while len(words) < STS_VOCAB:
        syllables = rng.integers(2, 5)
        words.add("".join(rng.choice(list(consonants)) + rng.choice(list(vowels))
                          for _ in range(syllables)))
    words = list(rng.permutation(sorted(words)))
    zipf = 1.0 / np.arange(1, STS_VOCAB + 1) ** 1.1
    zipf /= zipf.sum()

    def sentence(ids) -> str:
        toks = [words[i] + ("," if rng.random() < 0.25 else "") for i in ids]
        return " ".join(toks) + "."

    os.makedirs(root, exist_ok=True)
    for fname, n in STS_SPLITS:
        scores = np.round(5.0 * rng.beta(2.0, 5.0, n), 3)
        scores[(scores >= 2.5) & (scores < 2.6)] += 0.1
        rows = ["\t".join(["index", "genre", "filename", "year", "old_index", "source1",
                           "source2", "sentence1", "sentence2", "score"])]
        for i, score in enumerate(scores):
            s1 = rng.choice(STS_VOCAB, rng.integers(5, 31), p=zipf)
            keep = rng.random(len(s1)) < score / 5.0
            s2 = np.where(keep, s1, rng.choice(STS_VOCAB, len(s1), p=zipf))
            s2 = s2[: max(5, len(s2) - rng.integers(0, 4))]
            rows.append("\t".join(["x"] * 7 + [sentence(s1), sentence(s2), f"{score:.3f}"]))
        with open(os.path.join(root, fname), "w", encoding="utf-8") as fh:
            fh.write("\n".join(rows) + "\n")
    vectors = rng.normal(0.0, 0.5, size=(STS_VOCAB, 300)).astype(np.float32)
    with open(os.path.join(root, "glove.txt"), "w", encoding="utf-8") as fh:
        for i, (word, vec) in enumerate(zip(words, vectors)):
            if i % 10:
                fh.write(word + " " + " ".join(f"{v:.5f}" for v in vec) + "\n")


def sts_path_phase(ck, argv: list) -> tuple[dict, dict]:
    """Phase 11: the STS-B train path at full width. Returns its launches and
    result."""
    from imbalanced_regression_tpu_torch.tasks import stsb

    t0 = time.time()
    ck.reset_launch_counts()
    result = stsb.main(argv)
    torch.cuda.synchronize()
    launches = launch_counts(ck)
    log(f"STS-B path: {time.time() - t0:.1f}s, {result['iterations']} iterations, kernel "
        f"launches {launches}, K3 by kernel {dict(ck.segment_moments.kernels)}")
    for c in result["checks"]:
        log(f"val check {c['val_check']} (iter {c['iter']}, epoch {c['epoch']}): train_loss "
            f"{c['train_loss']:.5f} val_mse {c['val_mse']:.5f}, {c['pairs_per_sec']:.1f} pairs/s "
            f"(train {c['train_seconds']:.3f}s)")
    log(f"STS-B stats passes: {result['stats_pass_seconds']} s; test overall "
        f"{result['test']['overall']}")
    assert all(math.isfinite(c["train_loss"]) and math.isfinite(c["val_mse"])
               for c in result["checks"]), result["checks"]
    assert all(math.isfinite(v) for v in result["test"]["overall"].values()), result["test"]
    for name in ("calibrate_forward", "calibrate_backward", "segment_moments"):
        assert launches[name] > 0, f"{name} was not launched on the STS-B path"
    assert launches["segment_moments_v2"] == 0, launches
    assert ck.segment_moments.kernels == {"short": launches["segment_moments"]}, \
        ck.segment_moments.kernels
    cells = sts_cell_launches(argv, result)
    assert {k: launches[k] for k in cells} == cells, (launches, cells)
    fds = result["final_fds"]
    assert (fds.running_var_last_epoch != 1).any() and (fds.smoothed_mean_last_epoch != 0).any(), \
        "the last epoch calibrated with fds_init stats"
    return launches, result


def sts_resume_phase(ck, full: dict, full_store: str) -> dict:
    """Phase 12: the phase-11 run killed right after validation check 1's
    checkpoint (which holds the validation history) and resumed; then
    ``--evaluate --resume`` on its store. Returns the launches of the
    three runs."""
    from imbalanced_regression_tpu_torch.tasks import stsb
    from imbalanced_regression_tpu_torch.utils.checkpoint import checkpoint_path

    argv = with_root(STS_ARGV, f"{RESUME_ROOT}/sts_resumed")
    store = store_of(stsb.parse_sts_config(argv))
    t0 = time.time()
    resumed, killed, resumed_launches = killed_and_resumed(ck, stsb, argv, store, kill_at=1)
    ck.reset_launch_counts()
    evaluated = stsb.main(argv + ["--evaluate", "--resume", store])
    torch.cuda.synchronize()
    eval_launches = launch_counts(ck)
    diffs = resumed_equal(full, resumed, ("test", "best_val_mse", "iterations", "val_history"),
                          full_store, store)
    log(f"STS-B resume: {time.time() - t0:.1f}s for the three runs; uninterrupted val history "
        f"{full['val_history']}, resumed {resumed['val_history']}; bit-equal: {not diffs}"
        + (f" (differs: {diffs[:8]})" if diffs else ""))
    log(f"  launches: killed {killed}, resumed {resumed_launches}, evaluate {eval_launches}")
    log(f"STS-B checkpoint: {os.path.getsize(checkpoint_path(store, 'latest'))} bytes on disk")
    assert not diffs, f"the resumed STS-B run differs from the uninterrupted one: {diffs[:8]}"
    for name in ("calibrate_forward", "calibrate_backward", "segment_moments"):
        assert resumed_launches[name] > 0, f"{name} was not launched on the resumed STS-B run"
    # the killed and the resumed run together train, pass and evaluate as
    # phase 11's run; --evaluate runs the test batches' forwards
    cells = sts_cell_launches(argv, full)
    both = add_counts(killed, resumed_launches)
    assert {k: both[k] for k in cells} == cells, (both, cells)
    test_only = sts_cell_launches(argv, {"iterations": 0, "stats_pass_seconds": [],
                                         "val_history": []})
    assert {k: eval_launches[k] for k in cells} == test_only, (eval_launches, test_only)
    diffs = payload_diffs(resumed["test"], evaluated["test"])
    log(f"--evaluate of the resumed store: equal to its final test: {not diffs}")
    assert not diffs, diffs
    shutil.rmtree(f"{RESUME_ROOT}/sts_resumed")
    return add_counts(add_counts(killed, resumed_launches), eval_launches)


def sts_moe_phase(ck) -> dict:
    """Phase 19: the STS-B driver with ``--encoder deepseek_v2`` at
    DeepSeek-V2-Lite's widths (``STS_MOE_ARGV``): its steps and stats-pass
    batches replayed as graphs, the dispatch kernels launched exactly
    :func:`sts_moe_launches` times (a replay adds its graph's launches), no
    LSTM cell, every held expert routed rows. Returns its launches."""
    from imbalanced_regression_tpu_torch.tasks import stsb

    argv = with_root(STS_MOE_ARGV, f"{RESUME_ROOT}/sts_moe")
    t0 = time.time()
    ck.reset_launch_counts()
    result = stsb.main(argv)
    torch.cuda.synchronize()
    launches = launch_counts(ck)
    graphs = {kind: dict(n) for kind, n in result["trainer"].graph_stats.items()}
    routed = result["state"].backbone.routed_rows.tolist()
    want = sts_moe_launches(argv, result)
    log(f"STS-B DeepSeek-V2 path: {time.time() - t0:.1f}s, {result['iterations']} iterations, "
        f"{len(result['stats_pass_seconds'])} stats passes, graphs {graphs}, kernel launches "
        f"{launches} (dispatch kernels predicted {want}), routed rows by held expert {routed}, "
        f"test overall {result['test']['overall']}")
    assert all(math.isfinite(c["train_loss"]) and math.isfinite(c["val_mse"])
               for c in result["checks"]), result["checks"]
    assert {k: launches[k] for k in want} == want, (launches, want)
    assert launches["lstm_cell_forward"] == launches["lstm_cell_backward"] == 0, launches
    for name in ("calibrate_forward", "calibrate_backward", "segment_moments"):
        assert launches[name] > 0, f"{name} was not launched on the DeepSeek-V2 STS-B path"
    assert graphs["step"]["replays"] > 0 and graphs["pass"]["replays"] > 0, graphs
    assert all(n > 0 for layer in routed for n in layer), routed
    shutil.rmtree(f"{RESUME_ROOT}/sts_moe")
    return launches


def host_probe() -> dict:
    """What the host offers the JPEG loader: libjpeg's header and shared
    library, PIL, cores, memory and disk."""
    def sh(cmd: str) -> str:
        out = subprocess.run(cmd, shell=True, capture_output=True, text=True)
        return (out.stdout + out.stderr).strip()

    return {"jpeglib.h": os.path.exists("/usr/include/jpeglib.h"),
            "ldconfig": sh("ldconfig -p | grep -i jpeg") or "no libjpeg in ldconfig",
            "PIL": sh(f"{sys.executable} -c 'import PIL; print(PIL.__version__)'").splitlines()[-1],
            "nproc": sh("nproc"), "free -g": sh("free -g"), "df -h .": sh("df -h .")}


class RssPeak:
    """This process's largest resident set while the block runs, sampled
    every 10 ms on a thread (the card's machine refuses to reset the
    kernel's own peak, ``VmHWM``): ``start`` and ``peak`` in GB."""

    def __enter__(self):
        from imbalanced_regression_tpu_torch.utils.logging_tools import host_memory_gb

        self._rss = lambda: host_memory_gb()[0]
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def write_agedb_corpus(root: str = AGEDB_DIR, seed: int = 0) -> list[dict]:
    """``agedb.csv`` at ``AGEDB_SPLITS``' sizes, rows in a seeded order, and
    a copy of a seeded pick of the fixture JPEGs for each row. Train ages:
    three quarters from N(35, 6), a quarter uniform over 0-101; val and test
    uniform over 0-101. Returns the rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fixtures = sorted(os.path.join(FIXTURE_JPEGS, f) for f in os.listdir(FIXTURE_JPEGS))
    rows = []
    for split, n in AGEDB_SPLITS:
        if split == "train":
            skewed = rng.random(n) < 0.75
            ages = np.where(skewed, rng.normal(35, 6, n).round(), rng.integers(0, 102, n))
            ages = ages.clip(0, 101).astype(int)
        else:
            ages = rng.integers(0, 102, n)
        rows += [{"age": int(a), "split": split} for a in ages]
    rows = [rows[i] for i in rng.permutation(len(rows))]
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    picks = rng.integers(0, len(fixtures), len(rows))
    for i, (row, pick) in enumerate(zip(rows, picks)):
        row["path"] = f"imgs/{i:05d}.jpg"
        shutil.copyfile(fixtures[pick], os.path.join(root, row["path"]))
    write_meta_csv(os.path.join(root, "agedb.csv"), rows)
    return rows


def write_meta_csv(path: str, rows: list[dict]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("age,path,split\n" + "".join(f"{r['age']},{r['path']},{r['split']}\n"
                                              for r in rows))


def write_seeded_mmap_caches(data_dir: str, img_size: int = 224, seed: int = 0) -> None:
    """Where no JPEG decoder can be built: the decoded-image caches the
    driver's mmap mode looks for (one a split, under ``corpus_signature``
    of its paths, with the ``.ok`` marker), filled with uint8 images from
    ``seed``."""
    import numpy as np

    from imbalanced_regression_tpu_torch.data.age import read_meta_csv
    from imbalanced_regression_tpu_torch.data.streaming import corpus_signature

    rng = np.random.default_rng(seed)
    cache = os.path.join(data_dir, "_cache")
    os.makedirs(cache, exist_ok=True)
    for rows in read_meta_csv(os.path.join(data_dir, "agedb.csv")).values():
        paths = [os.path.join(data_dir, r["path"]) for r in rows]
        sig = corpus_signature(paths, img_size)
        npy = os.path.join(cache, f"images_{sig}.npy")
        out = np.lib.format.open_memmap(npy, mode="w+", dtype=np.uint8,
                                        shape=(len(paths), img_size, img_size, 3))
        for start in range(0, len(paths), 1024):
            stop = min(start + 1024, len(paths))
            out[start:stop] = rng.integers(0, 256, (stop - start, img_size, img_size, 3),
                                           dtype=np.uint8)
        out.flush()
        del out
        with open(npy + ".ok", "w") as fh:
            fh.write(sig)


def agedb_run(ck, argv: list) -> tuple[dict, dict, RssPeak]:
    """``tasks/age.py`` on ``argv`` with the launch counters set to 0 first.
    Returns the result, the launches and the host RSS it reached."""
    from imbalanced_regression_tpu_torch.tasks import age

    ck.reset_launch_counts()
    with RssPeak() as rss:
        result = age.main(argv)
        torch.cuda.synchronize()
    return result, launch_counts(ck), rss


def agedb_phase(ck) -> tuple[dict, dict]:
    """Phase 13. Returns the launches of the full-size run (N = 256 rows a
    kernel call) and of the mode legs (N = 64)."""
    from imbalanced_regression_tpu_torch.data import native_loader

    probe = host_probe()
    for key, value in probe.items():
        log(f"host probe {key}: {value}")
    t0 = time.time()
    rows = write_agedb_corpus()
    nbytes = sum(os.path.getsize(os.path.join(AGEDB_DIR, r["path"])) for r in rows)
    log(f"AgeDB-DIR-sized corpus: {len(rows)} rows, {nbytes} bytes of JPEG copies, written in "
        f"{time.time() - t0:.1f}s")
    # the loader decodes through libjpeg, or through PIL where the library
    # cannot be built; with neither, the phase trains on seeded mmap caches
    native = native_loader.get_lib() is not None
    decoder = "native libjpeg" if native else f"PIL {probe['PIL']}"
    decodes = native or importlib.util.find_spec("PIL") is not None
    argv = AGEDB_ARGV
    if decodes:
        threads = 8
        if not native:
            log(f"native loader unavailable ({native_loader.build_error()}); decoding with "
                f"{decoder}")
        # the first pass also reads the files into the page cache
        sample = [os.path.join(AGEDB_DIR, r["path"]) for r in rows[:1024]]
        for n_threads in (threads, 1, threads):
            t0 = time.perf_counter()
            native_loader.decode_resize_batch(sample, 224, threads=n_threads)
            dt = time.perf_counter() - t0
            log(f"decode ({decoder}): {len(sample)} files to 224x224 in {dt:.3f}s, "
                f"{len(sample) / dt:.1f} img/s with {n_threads} threads ({os.cpu_count()} cores)")
    else:
        log(f"decode: unavailable on this host ({native_loader.build_error()}; jpeglib.h "
            f"{probe['jpeglib.h']}, ldconfig: {probe['ldconfig']}, PIL: {probe['PIL']})")
        t0 = time.time()
        write_seeded_mmap_caches(AGEDB_DIR)
        log(f"mmap caches of seeded uint8 images written in {time.time() - t0:.1f}s")
        argv = AGEDB_ARGV + ["--data_mode", "mmap"]
    t0 = time.time()
    result, launches, rss = agedb_run(ck, argv)
    log(f"AgeDB path: {time.time() - t0:.1f}s, data load {result['data_seconds']:.2f}s"
        + (f" ({len(rows) / result['data_seconds']:.1f} img/s decoded)" if decodes else "")
        + f", host RSS {rss.start:.3f} GB at the start, peak {rss.peak:.3f} GB, "
        f"kernel launches {launches}, K3 by kernel {dict(ck.segment_moments.kernels)}")
    for h in result["history"]:
        log(f"epoch {h['epoch']}: train_loss {h['train_loss']:.4f} val_l1 {h['val_loss_l1']:.4f} "
            f"img/s {h['images_per_sec']:.1f} (train {h['train_seconds']:.2f}s, fds pass "
            f"{h['fds_pass_seconds']:.2f}s) calibrating {h['fds_calibrating']}")
    log(f"AgeDB test: {result['test']}")
    steps = dict(AGEDB_SPLITS)["train"] // AGEDB_BATCH
    assert all(math.isfinite(h["train_loss"]) for h in result["history"]), result["history"]
    assert all(math.isfinite(v) for v in result["test"].values()), result["test"]
    want = launches_of(calibrate_forward=steps, calibrate_backward=steps,
                       segment_moments=2 * steps)
    assert launches == want, f"launches {launches}, expected {want}"
    assert ck.segment_moments.kernels == {"short": 2 * steps}, ck.segment_moments.kernels
    # two epochs: epoch 1 calibrates with the snapshot its own pass has not
    # taken yet (fds_init's); the two passes moved the statistics
    fds = result["final_fds"]
    assert (fds.running_var_last_epoch != 1).any() and (fds.smoothed_mean_last_epoch != 0).any()
    del result

    legs_launches = {}
    if decodes:
        write_meta_csv(f"{LEGS_DIR}/agedb.csv",
                       [{**r, "path": f"../{r['path']}"} for r in rows[:LEG_ROWS]])
        outcomes = {}
        for mode in ("ram", "mmap", "stream"):
            with cudnn_determinism(True):
                t0 = time.time()
                leg, counts, rss = agedb_run(ck, LEG_ARGV + ["--data_mode", mode])
            h = leg["history"][0]
            log(f"leg {mode}: {time.time() - t0:.1f}s, data load {leg['data_seconds']:.2f}s"
                + (" (the mmap cache build)" if mode == "mmap" else "")
                + f", {h['images_per_sec']:.1f} img/s, host RSS {rss.start:.3f} GB at the start, "
                f"peak {rss.peak:.3f} GB, train_loss "
                f"{h['train_loss']!r}, test {leg['test']}, launches {counts}")
            outcomes[mode] = ([x["train_loss"] for x in leg["history"]], leg["test"],
                              leg["best_loss"])
            legs_launches = add_counts(legs_launches, counts)
        equal = all(o == outcomes["ram"] for o in outcomes.values())
        log(f"legs ram / mmap / stream bit-equal: {equal}")
        assert equal, outcomes
    else:
        log("legs skipped: no decoder for the ram and stream modes")
    shutil.rmtree(AGEDB_DIR)
    return launches, legs_launches


def rows_of(x, n: int):
    return {k: v[:n] for k, v in x.items()} if isinstance(x, dict) else x[:n]


def hold_predictor(name: str, predict, trainer, state, x) -> dict:
    """``predict(x)`` against ``trainer.predict_batch`` on the same restored
    state and batch under ``cudnn.deterministic``: finite, the same shape,
    within ``SERVE_TOL`` of the largest magnitude (bit-equality logged);
    then a batch of half the size is refused, and both are timed on the
    host clock (10 calls each). Returns the max |diff|, whether the two
    were bit-equal and the two times."""
    import numpy as np

    n = len(next(iter(x.values()))) if isinstance(x, dict) else len(x)
    batch = {"input": x, "target": np.zeros((n, 1), np.float32)}
    with cudnn_determinism(True):
        got = predict(x)
        want = trainer.predict_batch(state, batch)
    assert got.shape == want.shape and np.isfinite(got).all(), (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max())
    scale = float(np.abs(want).max())
    equal = bool(np.array_equal(got, want))
    log(f"serving {name}: predictor vs predict_batch on {n} rows: max |diff| {err!r} (largest "
        f"|prediction| {scale!r}, tolerance {SERVE_TOL * scale!r}), bit-equal: {equal}")
    assert err <= SERVE_TOL * scale, f"{name}: the predictor is {err} from predict_batch"
    try:
        predict(rows_of(x, n // 2))
    except ValueError as exc:
        log(f"serving {name}: batch {n // 2} refused: {exc}")
    else:
        raise AssertionError(f"{name}: a predictor exported for batch {n} served batch {n // 2}")
    # host numpy in, predictions on the host: each call ends in the fetch
    times = {}
    for key, fn in (("serve_ms", lambda: predict(x)),
                    ("predict_batch_ms", lambda: trainer.predict_batch(state, batch))):
        fn()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        times[key] = (time.perf_counter() - t0) * 1e2
    log(f"serving {name}: ms per call on the host clock, predictor {times['serve_ms']!r}, "
        f"predict_batch {times['predict_batch_ms']!r}")
    return {"max_abs_err": err, "bit_equal": equal, **times}


def export_by_cli(task: str, store: str, batch: int):
    """``tools/export_model.py`` on ``store``'s ``best`` checkpoint at
    ``batch`` (the task's default input dtype, on cuda), then
    ``load_predictor_file``. Returns the loaded predictor, the artifact's
    path and the CLI's and the load's seconds."""
    from imbalanced_regression_tpu_torch.serving import load_predictor_file
    from imbalanced_regression_tpu_torch.tools import export_model

    out = f"{SERVE_DIR}/{task}.pt2"
    t0 = time.perf_counter()
    export_model.main([store, out, "--task", task, "--batch", str(batch)])
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    predict = load_predictor_file(out)
    return predict, out, cli_s, time.perf_counter() - t0


def serving_phase(ck, age_store: str, depth_store: str, sts_argv: list) -> dict:
    """Phase 14: the frozen predictors of phase 8's age store (ResNet-50,
    bf16, uint8 224x224, batch 128, by the export CLI), phase 10's depth
    store (228x304 float32, batch 8, by the CLI) and phase 11's STS-B store
    (d_hid 1500, bf16, batch 128 of pairs padded to 40 tokens, by the API)
    held against ``predict_batch`` on the same restored states; then
    ``tools/serve_bench.py`` on the age store at batches 1-128. No FDS
    kernel launches while the phase runs. Returns its records."""
    import numpy as np

    from imbalanced_regression_tpu_torch.data.stsb import load_stsb_datasets
    from imbalanced_regression_tpu_torch.serving import (
        export_predictor,
        load_predictor,
        save_predictor,
    )
    from imbalanced_regression_tpu_torch.tasks import stsb
    from imbalanced_regression_tpu_torch.tools import export_model, serve_bench
    from imbalanced_regression_tpu_torch.utils.checkpoint import restore_checkpoint

    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    os.makedirs(SERVE_DIR)
    rng = np.random.default_rng(14)
    ck.reset_launch_counts()
    records = {}
    t_phase = time.time()
    for task, store, batch in (("age", age_store, SERVE_AGE_BATCH),
                               ("nyud2", depth_store, SERVE_DEPTH_BATCH)):
        predict, out, cli_s, load_s = export_by_cli(task, store, batch)
        trainer, state = export_model.build_task(
            task, {"img_size": 224} if task == "age" else {}, "cuda")
        state, _, _ = restore_checkpoint(store, state, which="best")
        shape = export_model.sample_shape(task, batch, 224)
        x = (rng.integers(0, 256, shape, dtype=np.uint8) if task == "age"
             else rng.random(shape, dtype=np.float32))
        assert predict.data_avals[0] == (shape, x.dtype), predict.data_avals
        records[task] = {"input": f"{x.dtype}{list(shape)}", "export_cli_s": cli_s,
                         "load_s": load_s, "artifact_bytes": os.path.getsize(out),
                         **hold_predictor(task, predict, trainer, state, x)}
        log(f"serving {task}: {records[task]}")
        del predict, trainer, state

    # STS-B by the API: the export CLI serves age and NYUD2 only, as in JAX
    scfg = stsb.parse_sts_config(sts_argv)
    _, _, test, emb, vocab = load_stsb_datasets(scfg.data_dir, scfg)
    trainer = stsb.build_sts_trainer(scfg, len(vocab), emb)
    state, _, _ = restore_checkpoint(store_of(scfg), trainer.init_state(0), which="best")
    x = rows_of(test["input"], SERVE_STS_BATCH)
    assert all(v.shape == (SERVE_STS_BATCH, scfg.max_seq_len) for v in x.values())
    t0 = time.perf_counter()
    blob = export_predictor(trainer, state, x)
    export_s = time.perf_counter() - t0
    save_predictor(f"{SERVE_DIR}/stsb.pt2", blob)
    t0 = time.perf_counter()
    predict = load_predictor(blob)
    load_s = time.perf_counter() - t0
    records["stsb"] = {"input": f"dict of 4 x [{SERVE_STS_BATCH}, {scfg.max_seq_len}]",
                       "export_s": export_s, "load_s": load_s, "artifact_bytes": len(blob),
                       "graph_nodes": len(predict.module.graph.nodes),
                       **hold_predictor("stsb", predict, trainer, state, x)}
    log(f"serving stsb: {records['stsb']}")
    del predict, trainer, state, blob

    t0 = time.time()
    rows = serve_bench.main(["--task", "age", "--checkpoint", age_store,
                             "--batches", *SERVE_BENCH_BATCHES])
    log(f"serve_bench age: {time.time() - t0:.1f}s for {len(rows)} batch sizes")
    assert [r["batch"] for r in rows] == [int(b) for b in SERVE_BENCH_BATCHES]
    assert all(r["ms_per_batch"] > 0 and r["device_ms"] > 0 for r in rows), rows
    records["serve_bench_age"] = rows
    torch.cuda.synchronize()
    launches = launch_counts(ck)
    log(f"serving phase: {time.time() - t_phase:.1f}s, kernel launches {launches}")
    # the STS-B predictor's forward may run the cell; nothing else may launch
    assert not any(n for k, n in launches.items() if k != "lstm_cell_forward"), \
        f"an FDS kernel or a cell backward launched while serving: {launches}"
    shutil.rmtree(SERVE_DIR)
    return records


def age_predicted_launches(cfg, rrt_stage2: bool = False) -> dict:
    """The kernel launches one rank of the age path on synthetic data makes
    under ``cfg``: with FDS, K1 and K2 once a train step from
    ``start_smooth`` on (K2 never in RRT stage 2, whose frozen backbone
    takes no gradient), K3 once a stats-pass batch from ``start_update``
    on (the pass runs the train split's drop-last batches, as many as the
    steps), K4 never."""
    steps = int(cfg.synthetic_size * 0.7) // cfg.batch_size  # tasks/age.py's 70% train split
    calibrating = steps * max(cfg.epoch - cfg.start_smooth, 0) if cfg.fds else 0
    return launches_of(calibrate_forward=calibrating,
                       calibrate_backward=0 if rrt_stage2 else calibrating,
                       segment_moments=steps * max(cfg.epoch - cfg.start_update, 0) if cfg.fds
                       else 0)


def dp_age_phase(ck) -> dict:
    """Phase 15(a): the age driver at full width (ResNet-50 in bf16, LDS +
    FDS, global batch 128) on two gloo ranks sharing the card, beside the
    same command on one process, both under ``cudnn.deterministic``.
    Returns the ranks' launches, summed."""
    from imbalanced_regression_tpu_torch.tasks import age
    from imbalanced_regression_tpu_torch.utils.config import parse_config

    predicted = age_predicted_launches(parse_config(DP_ARGV))
    with cudnn_determinism(True):
        ck.reset_launch_counts()
        t0 = time.time()
        one = age.main(DP_ARGV + ["--num_devices", "1"])
        torch.cuda.synchronize()
        one_launches = launch_counts(ck)
        t1 = time.time()
        dp = age.main(DP_ARGV + ["--num_devices", str(DP_RANKS), "--dist_backend", "gloo"])
        t2 = time.time()
    log(f"DP age path: one process {t1 - t0:.1f}s, {DP_RANKS} ranks {t2 - t1:.1f}s (rank start-up "
        "included)")
    reports = dp["ranks"]
    assert [r["rank"] for r in reports] == list(range(DP_RANKS)), reports
    assert len({r["digest"] for r in reports}) == 1, \
        "the ranks ended with different parameters, BN buffers or FDS state"
    tracked = one["final_fds"].num_samples_tracked.cpu()
    assert torch.equal(dp["final_fds"].num_samples_tracked, tracked), "FDS counts differ"
    gaps = {}
    for h1, hd in zip(one["history"], dp["history"], strict=True):
        gap = abs(hd["train_loss"] - h1["train_loss"]) / abs(h1["train_loss"])
        gaps[f"train_loss[{h1['epoch']}]"] = gap
    for key in ("mse", "l1", "gmean"):
        gaps[f"test_{key}"] = abs(dp["test"][key] - one["test"][key]) / abs(one["test"][key])
    log("DP against one process, relative gaps: "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f" (one: {[h['train_loss'] for h in one['history']]}, test {one['test']}; "
        f"DP: {[h['train_loss'] for h in dp['history']]}, test {dp['test']})")
    assert all(g <= DP_REL_TOL for g in gaps.values()), gaps
    log(f"DP predicted launches a rank {predicted}; one process {one_launches}; ranks "
        f"{[r['launches'] for r in reports]}, K3 kernels {[r['k3_kernels'] for r in reports]}")
    assert one_launches == predicted, one_launches
    for r in reports:
        assert r["launches"] == predicted, r["launches"]
        assert r["k3_kernels"] == {"short": predicted["segment_moments"]}, r["k3_kernels"]
    for h in dp["history"]:
        log(f"DP epoch {h['epoch']}: img/s {h['images_per_sec']:.1f} "
            f"({h['images_per_sec_per_rank']:.1f} a rank; two ranks on one card through gloo's host round trip: a correctness gate, "
            f"not a scaling number), train {h['train_seconds']:.2f}s, fds pass "
            f"{h['fds_pass_seconds']:.2f}s, calibrating {h['fds_calibrating']}")
    for h in one["history"]:
        log(f"one process epoch {h['epoch']}: img/s {h['images_per_sec']:.1f}, train "
            f"{h['train_seconds']:.2f}s")
    for r in reports:
        c = r["collectives"]
        log(f"rank {r['rank']}: {c['calls']} collectives, {c['bytes'] / 1e6:.1f} MB reduced, "
            f"{c['seconds']:.3f}s in them over {r['steps']} steps and 2 stats passes "
            f"({c['seconds'] / r['steps']:.4f}s a step)")
    return {k: sum(r["launches"][k] for r in reports) for k in predicted}


def f32_step(mesh, perturb: float = 0.0) -> dict:
    """One step of the ResNet-50 Trainer in float32 (TF32 off) with the
    age FDS calibrating, SGD, on a global batch of ``DP_F32_BATCH`` 224x224
    images (scaled by ``1 + perturb``), from seed 0; its global loss, its
    weights before and after (BN buffers apart), its BN buffers and its
    digest."""
    from imbalanced_regression_tpu_torch.data.augment import random_crop_flip_normalize
    from imbalanced_regression_tpu_torch.data.synthetic import synthetic_age_dataset
    from imbalanced_regression_tpu_torch.fds import FDSConfig
    from imbalanced_regression_tpu_torch.models.resnet import RegressionHead, ResNetBackbone
    from imbalanced_regression_tpu_torch.parallel.launch import state_digest
    from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig

    trainer = Trainer(ResNetBackbone(dtype=torch.float32), RegressionHead(2048),
                      TrainerConfig(loss="l1", optimizer="sgd", lr=1e-3),
                      fds_config=FDSConfig.for_age(start_smooth=0),
                      train_augment=random_crop_flip_normalize, device="cuda", mesh=mesh)
    state = trainer.init_state(0)

    def tensors(running: bool) -> dict:
        return {f"{part}.{k}": v.detach().cpu().clone() for part in ("backbone", "head")
                for k, v in getattr(state, part).state_dict().items() if ("running" in k) == running}

    before = tensors(running=False)
    data = synthetic_age_dataset(n=DP_F32_BATCH, img_size=224, seed=5)
    data["input"] = data["input"] * (1.0 + perturb)
    state, loss, _ = trainer.train_step(state, data, epoch=1)
    return {"loss": float(trainer.rank_mean(loss)), "before": before,
            "weights": tensors(running=False), "buffers": tensors(running=True),
            "digest": state_digest(state),
            "collectives": None if mesh is None else mesh.stats.calls}


def _dp_checks_rank() -> dict:
    """One rank of (b) and (d), on one start of the ranks: the float32 step
    (rank 0 alone sends its tensors back; the digest shows the ranks
    equal), then the dry run's checks."""
    from imbalanced_regression_tpu_torch.parallel.dryrun import dryrun_rank
    from imbalanced_regression_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(DP_RANKS, backend="gloo", device="cuda")
    f32 = f32_step(mesh)
    del f32["before"]
    if mesh.rank != 0:
        del f32["weights"], f32["buffers"]
    return {"f32": f32, "dryrun": dryrun_rank(DP_RANKS, "cuda")}


def update_gap(a: dict, b: dict, before: dict, keys) -> float:
    """||a - b|| / ||b - before|| over the weights ``keys``: how far two
    steps' updates differ, relative to the step."""
    num = sum(float((a[k] - b[k]).double().square().sum()) for k in keys)
    den = sum(float((b[k] - before[k]).double().square().sum()) for k in keys)
    return math.sqrt(num / den)


def dp_f32_nccl_dryrun_phase() -> None:
    """Phase 15(c), then (b) and (d) on one start of two gloo ranks sharing
    the card.

    (c): a one-rank NCCL group's step through ``create_mesh``, bit-equal to
    the step without a mesh.

    (b): the ranks' float32 step against one process's. The loss, the BN
    running buffers (forward statistics) and the head's weights are held to
    JAX ``tests/test_parallel.py``'s bounds (1e-5 relative; rtol 1e-4 / atol
    1e-5). The backbone's gradients at init are ill-conditioned in float32:
    the one-process step on inputs scaled by 1 + 2^-23 moves its weights by
    up to ~4e-4 against the unscaled step (SGD, lr 1e-3). So the backbone's
    update may differ from one process's by no more than 4 times that
    step's own rounding-level gap (``update_gap``); both gaps are logged
    with the count of weights outside the JAX bound.

    (d): ``dryrun_multichip``'s checks (``dryrun_rank`` on each rank,
    ``check_ranks`` over them): the age, STS-B and NYUD2 families' DP train
    step, stats pass, padded eval and RRT step, with K1-K3 launched on each
    rank."""
    import torch.distributed as dist

    from imbalanced_regression_tpu_torch.parallel.dryrun import check_ranks
    from imbalanced_regression_tpu_torch.parallel.launch import run_ranks
    from imbalanced_regression_tpu_torch.parallel.mesh import create_mesh

    t0 = time.time()
    with cudnn_determinism(True):
        mesh = create_mesh(1, backend="nccl", device="cuda")
        try:
            nccl = f32_step(mesh)
        finally:
            dist.destroy_process_group()
        one = f32_step(None)
        perturbed = f32_step(None, perturb=2.0**-23)
    log(f"NCCL one rank: {nccl['collectives']} collectives, loss {nccl['loss']!r} against "
        f"{one['loss']!r} without a mesh; bit-equal: {nccl['digest'] == one['digest']} "
        f"({time.time() - t0:.1f}s with the two steps without a mesh)")
    assert nccl["collectives"] > 0 and mesh.backend == "nccl"
    assert nccl["digest"] == one["digest"] and nccl["loss"] == one["loss"]

    t0 = time.time()
    with cudnn_determinism(True):
        ranks = run_ranks(_dp_checks_rank, DP_RANKS, backend="gloo", timeout_s=600)
    log(f"(b) and (d) on {DP_RANKS} gloo ranks: {time.time() - t0:.1f}s, rank start-up included")
    assert ranks[0]["f32"]["digest"] == ranks[1]["f32"]["digest"], \
        "the float32 ranks ended with different weights"
    dp = ranks[0]["f32"]

    def outside(run: dict) -> int:
        return sum(int((~torch.isclose(run["weights"][k], v, rtol=1e-4, atol=1e-5)).sum())
                   for k, v in one["weights"].items())

    backbone = [k for k in one["weights"] if k.startswith("backbone.")]
    gaps = {name: update_gap(run["weights"], one["weights"], one["before"], backbone)
            for name, run in (("dp", dp), ("perturbed", perturbed))}
    loss_gap = abs(dp["loss"] - one["loss"]) / abs(one["loss"])
    log(f"float32 step ({DP_RANKS} gloo ranks, global batch {DP_F32_BATCH}, 224x224): loss "
        f"{dp['loss']!r} against {one['loss']!r} (relative gap {loss_gap:.3e}; inputs x (1 + "
        f"2^-23): {abs(perturbed['loss'] - one['loss']) / abs(one['loss']):.3e}); backbone "
        f"update gap {gaps['dp']:.3e} (inputs x (1 + 2^-23): {gaps['perturbed']:.3e}); weights "
        f"outside rtol 1e-4 / atol 1e-5: {outside(dp)} (perturbed: {outside(perturbed)}) of "
        f"{sum(v.numel() for v in one['weights'].values())}")
    assert loss_gap <= 1e-5, loss_gap
    for k, v in one["buffers"].items():
        torch.testing.assert_close(dp["buffers"][k], v, rtol=1e-4, atol=1e-5, msg=k)
    for k, v in one["weights"].items():
        if k.startswith("head."):
            torch.testing.assert_close(dp["weights"][k], v, rtol=1e-4, atol=1e-5, msg=k)
    assert gaps["dp"] <= 4 * gaps["perturbed"], gaps

    out = check_ranks([r["dryrun"] for r in ranks])
    log(f"dry run (dryrun_multichip's checks) on the same ranks: {out['seconds']:.1f}s in rank 0 "
        "from its mesh on ("
        + ", ".join(f"{f} {out[f]['seconds']:.1f}s" for f in ("age", "stsb", "nyud2"))
        + "), losses " + ", ".join(f"{f} {out[f]['loss']:.4f}" for f in ("age", "stsb", "nyud2"))
        + f"; launches by rank {[r['launches'] for r in out['ranks']]}")
    for r in out["ranks"]:
        for name in ("calibrate_forward", "calibrate_backward", "segment_moments"):
            assert r["launches"][name] > 0, f"{name} was not launched on a dry-run rank"


def dp_phase(ck, cal, dev) -> dict:
    """Phase 15: data parallelism on the card (a)-(d), then K1-K3 at the
    depth path's rows a rank (N = 16 x 114 x 152), logged. Returns (a)'s
    launches."""
    t0 = time.time()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    launches = dp_age_phase(ck)
    dp_f32_nccl_dryrun_phase()
    gen = torch.Generator(device=dev).manual_seed(15)
    n = N_DEPTH // DP_RANKS
    per_rank = check_calibrate(ck, cal, gen, dev, n, *DEPTH, [("positive", (0.2, 5.0))],
                               record=True, iters=10)
    per_rank.update(check_moments(ck, gen, dev, n, *DEPTH, record=True, iters=10,
                                  names=("segment_moments",)))
    log("depth rows a rank (phase 15's layout at the depth path's global batch 32):")
    log_records(per_rank)
    log(f"data-parallel phase: {time.time() - t0:.1f}s")
    return launches


def bench_phase(ck) -> dict:
    """Phase 16(a): ``tools/bench.py`` at its defaults. Returns its
    launches: K1 and K2 once a step (warm-up and timed), K3 none."""
    from imbalanced_regression_tpu_torch.tools import bench

    ck.reset_launch_counts()
    t0 = time.time()
    line = bench.main([])
    torch.cuda.synchronize()
    launches = launch_counts(ck)
    log(f"bench ({time.time() - t0:.1f}s): {json.dumps(line)}")
    steps = bench.WARMUP + bench.STEPS
    assert line["batch"] == BENCH_BATCH and line["launches"] == launches, line
    assert launches == launches_of(calibrate_forward=steps, calibrate_backward=steps), launches
    assert math.isfinite(line["final_loss"]) and line["value"] > 0, line
    return launches


def sweep_predicted_launches(argv: list) -> dict:
    """The launches of ``tools/sweep.py`` over ``argv``'s grid: each cell's
    and each RRT stage 2's (``age_predicted_launches``)."""
    from imbalanced_regression_tpu_torch.tools import sweep

    args = sweep.parse_args(argv)
    total = {}
    for cfg in sweep.grid(args):
        total = add_counts(total, age_predicted_launches(cfg))
        if args.rrt and cfg.reweight != "none":
            total = add_counts(total, age_predicted_launches(cfg, rrt_stage2=True))
    return total


def sweep_phase(ck) -> dict:
    """Phase 16(b): ``tools/sweep.py`` over ``SWEEP_ARGV``'s grid at full
    width (five runs, each timed), then the same command again, which
    skips every cell from the JSONL and launches nothing, then the port's
    aggregate table. Returns the first sweep's launches."""
    from imbalanced_regression_tpu_torch.tools import aggregate_results, sweep

    root = SWEEP_ARGV[SWEEP_ARGV.index("--store_root") + 1]
    shutil.rmtree(root, ignore_errors=True)
    real_run, seconds = sweep.age.run, []

    def timed_run(config):
        t0 = time.time()
        result = real_run(config)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        return result

    sweep.age.run = timed_run
    try:
        ck.reset_launch_counts()
        t0 = time.time()
        path = sweep.main(SWEEP_ARGV)
        torch.cuda.synchronize()
        launches = launch_counts(ck)
        t1 = time.time()
        records = aggregate_results.load(path)
        ck.reset_launch_counts()
        sweep.main(SWEEP_ARGV)
        relaunch = launch_counts(ck)
        t2 = time.time()
    finally:
        sweep.age.run = real_run
    predicted = sweep_predicted_launches(SWEEP_ARGV)
    stage2 = [r for r in records if "rrt_from" in r]
    log(f"sweep: {t1 - t0:.1f}s for {len(records)} runs, seconds a run "
        f"{[round(x, 2) for x in seconds]}; launches {launches} (predicted {predicted}); "
        f"relaunch {t2 - t1:.2f}s, launches {relaunch}")
    assert len(records) == len(seconds) == 5 and len(stage2) == 2, [r["name"] for r in records]
    assert all(r["rrt_from"] == r["config"]["pretrained"].rsplit("/", 1)[-1] for r in stage2)
    assert all(r["config"]["fds"] for r in records)
    assert all(math.isfinite(v) for r in records for v in r["test"].values()), records
    assert launches == predicted, launches
    assert not any(relaunch.values()), relaunch
    assert aggregate_results.load(path) == records, "the relaunch appended records"
    aggregate_results.print_table(aggregate_results.aggregate(records, "l1"), "l1")
    sys.stdout.flush()
    shutil.rmtree(root)
    return launches


def sts_layout_window(trainer, state, batches, epoch: int) -> tuple[float, float, int]:
    """(host-clock ms a step, device busy ms a step, device activities a
    step) of the indexed train step: ``STS_STEPS``' warm-up, then its
    host-timed steps, then its profiled ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    warmup, timed, profiled = STS_STEPS
    for idx in batches[:warmup]:
        trainer.train_step_indexed(state, idx, epoch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in batches[warmup:warmup + timed]:
        trainer.train_step_indexed(state, idx, epoch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / timed
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for idx in batches[warmup + timed:warmup + timed + profiled]:
            trainer.train_step_indexed(state, idx, epoch)
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return host_ms, sum(times) / profiled, len(times) // profiled


def sts_flax_phase(ck) -> dict:
    """Phase 16(c): the STS-B driver with ``--lstm_impl flax`` at full width
    on phase 11's corpus (45 iterations: one stats pass after the 41 steps
    of epoch 0, K1/K2 in the 4 steps after it, one validation check), then ``--evaluate --resume`` on
    its store without the flag (the layout from the checkpoint), which
    reproduces the run's test metrics; then the train step in the fused
    and the per-direction layouts side by side. Returns the run's
    launches."""
    import numpy as np

    from imbalanced_regression_tpu_torch.data.batching import index_iterator
    from imbalanced_regression_tpu_torch.data.stsb import load_stsb_datasets
    from imbalanced_regression_tpu_torch.tasks import stsb

    root = f"{TOOLS_ROOT}/sts_flax"
    argv = with_root(STS_ARGV + STS_FLAX_BUDGET + ["--lstm_impl", "flax"], root)
    cfg = stsb.parse_sts_config(argv)
    store = store_of(cfg)
    train, _, _, emb, vocab = load_stsb_datasets(cfg.data_dir, cfg)
    n = len(train["target"])
    # epoch 0's steps, then the stats pass over as many batches, then the
    # calibrating steps of epoch 1
    n_batches = n // STS_BATCH
    calibrating = cfg.val_interval * cfg.max_vals - n_batches
    # the per-direction layout runs no LSTM cell kernel
    predicted = launches_of(calibrate_forward=calibrating, calibrate_backward=calibrating,
                            segment_moments=n_batches)
    ck.reset_launch_counts()
    t0 = time.time()
    result = stsb.main(argv)
    torch.cuda.synchronize()
    launches = launch_counts(ck)
    t1 = time.time()
    evaluated = stsb.main(STS_ARGV + STS_FLAX_BUDGET + ["--store_root", root, "--evaluate",
                                                         "--resume", store])
    torch.cuda.synchronize()
    diffs = payload_diffs(result["test"], evaluated["test"])
    log(f"STS-B flax layout: {t1 - t0:.1f}s, {result['iterations']} iterations, launches "
        f"{launches} (predicted {predicted}), K3 by kernel {dict(ck.segment_moments.kernels)}; "
        f"val {result['val_history']}, stats pass {result['stats_pass_seconds']} s; test "
        f"overall {result['test']['overall']}; --evaluate without the flag ({time.time() - t1:.1f}"
        f"s) equal: {not diffs}")
    encoder = result["trainer"].backbone
    assert encoder.lstm_impl == "flax", encoder.lstm_impl
    assert result["iterations"] == cfg.val_interval * cfg.max_vals, result["iterations"]
    assert len(result["stats_pass_seconds"]) == 1 and calibrating > 0, result["checks"]
    assert all(math.isfinite(c["train_loss"]) for c in result["checks"]), result["checks"]
    assert all(math.isfinite(v) for v in result["test"]["overall"].values()), result["test"]
    assert launches == predicted, launches
    assert not diffs, diffs
    del result, encoder

    batches = list(index_iterator(n, STS_BATCH, rng=np.random.default_rng(2)))[:sum(STS_STEPS)]
    for impl in ("fused", "flax"):
        trainer = stsb.build_sts_trainer(dataclasses.replace(cfg, lstm_impl=impl), len(vocab), emb)
        state = trainer.init_state(0)
        trainer.bind_device_data(train)
        for epoch in (0, 1):  # a non-trivial snapshot: the steps calibrate
            state = trainer.fds_epoch_pass_indexed(
                state, list(index_iterator(n, STS_BATCH, rng=np.random.default_rng(epoch)))[:2],
                epoch)
        host_ms, busy_ms, activities = sts_layout_window(trainer, state, batches, 2)
        params = sum(p.numel() for p in state.backbone.bilstm.parameters())
        log(f"STS-B step, {impl} layout ({params} BiLSTM parameters): {host_ms:.2f} ms/step on "
            f"the host clock ({STS_BATCH * 1e3 / host_ms:.1f} pairs/s), device busy "
            f"{busy_ms:.2f} ms/step, {activities} device activities/step")
        del trainer, state
    shutil.rmtree(root)
    return launches


def data_tools_phase() -> None:
    """Phase 16(d): the dataset tools on this machine, with no pandas: a
    small IMDB-WIKI-shaped JPEG corpus (``make_synth_corpus``), an AgeDB
    directory of its ages (``create_age_meta agedb``), its balanced splits
    (``make_balanced_splits``), an FDS subset of a NYUD2 CSV
    (``preprocess_nyud2``) and corpus word vectors from the first 400 pairs
    of phase 11's train split (``corpus_embeddings``)."""
    import csv

    from imbalanced_regression_tpu_torch.tools import (
        corpus_embeddings,
        create_age_meta,
        make_balanced_splits,
        make_synth_corpus,
        preprocess_nyud2,
    )

    root = f"{TOOLS_ROOT}/data"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    synth = make_synth_corpus.main(["--root", root, "--name", "synth", "--n", "600", "--val", "0",
                                    "--test", "0", "--src_size", "64", "--protos", "8"])
    with open(synth, newline="") as fh:
        ages = [r["age"] for r in csv.DictReader(fh)]
    os.makedirs(f"{root}/AgeDB")
    for i, a in enumerate(ages):
        open(f"{root}/AgeDB/{i}_Name{i}_{a}_{'mf'[i % 2]}.jpg", "w").close()
    meta = create_age_meta.main(["agedb", "--data_path", root])
    splits = make_balanced_splits.main(["--db", "agedb", "--data_path", root, "--max_size", "30"])
    with open(splits, newline="") as fh:
        rows = list(csv.DictReader(fh))
    counts = {k: sum(r["split"] == k for r in rows) for k in ("train", "val", "test")}
    with open(f"{root}/nyu2_train.csv", "w") as fh:
        fh.writelines(f"data/nyu2_train/s/{i}.jpg,data/nyu2_train/s/{i}.png\n" for i in range(50))
    subset = preprocess_nyud2.create_fds_subset(root, size=12, seed=0)
    with open(f"{STS_DIR}/train_new.tsv", encoding="utf-8") as fh:
        head = list(itertools.islice(fh, 401))  # the header and 400 pairs
    os.makedirs(f"{root}/sts")
    with open(f"{root}/sts/train_new.tsv", "w", encoding="utf-8") as fh:
        fh.writelines(head)
    vectors = corpus_embeddings.main(["--data_dir", f"{root}/sts", "--out",
                                      f"{root}/vectors.txt", "--dim", "50"])
    with open(vectors, encoding="utf-8") as fh:
        n_vectors = sum(1 for _ in fh)
    with open(subset, newline="") as fh:
        n_subset = sum(1 for _ in csv.reader(fh))
    log(f"dataset tools ({time.time() - t0:.1f}s): synthetic corpus {len(ages)} rows, agedb meta "
        f"{meta}, balanced splits {counts}, FDS subset {n_subset} rows, {n_vectors} corpus vectors; "
        f"pandas imported: {'pandas' in sys.modules}")
    assert len(rows) == len(ages) == 600 and counts["val"] == counts["test"] > 0, counts
    assert n_subset == 12 and n_vectors > 100, (n_subset, n_vectors)
    assert "pandas" not in sys.modules, "a tool of the port imported pandas"
    shutil.rmtree(root)


def tools_phase(ck) -> tuple[dict, dict, dict]:
    """Phase 16: the bench, the sweep, the per-direction STS-B layout and
    the dataset tools. Returns the launches of the first three."""
    t0 = time.time()
    bench = bench_phase(ck)
    sweep_launches = sweep_phase(ck)
    sts = sts_flax_phase(ck)
    data_tools_phase()
    log(f"tools phase: {time.time() - t0:.1f}s")
    return bench, sweep_launches, sts


def tutorial_kernel_phase(ck, cal, dev) -> dict:
    """Phase 17(a): K1 and K2 bit-equal to their plain versions at the
    tutorial's step (N = 128, D = 64, B = 51: a row tile of 16 threads, 16
    rows a block), K3 against its plain version and float64 on its stats
    pass (N = 1,749, D = 64: the short kernel's lanes 16-31 own no column);
    each timed. Returns the records."""
    gen = torch.Generator(device=dev).manual_seed(17)
    (d, b), sm = TUTORIAL, torch.cuda.get_device_properties(dev).multi_processor_count
    for bwd in (False, True):
        log(f"K{1 + bwd} plan at N={TUTORIAL_BATCH} D={d} B={b}: "
            f"{ck.calibrate_plan(TUTORIAL_BATCH, d, b, sm, bwd)}")
    records = check_calibrate(ck, cal, gen, dev, TUTORIAL_BATCH, d, b,
                              [("nonzero", (0.1, 10.0)), ("positive", (0.5, 2.0))], record=True)
    records.update(check_moments(ck, gen, dev, TUTORIAL_ROWS, d, b, record=True,
                                 names=("segment_moments",), empty_bucket=True))
    assert ck.moments_plan(TUTORIAL_ROWS, d, sm).kernel == "short"
    f, idx = moments_inputs(gen, dev, TUTORIAL_ROWS, d, b, empty_bucket=True)
    rel_s, rel_q = check_against_float64("segment_moments", ck.segment_moments(f, idx, b),
                                         float64_moments(f, idx, b))
    log(f"segment_moments N={TUTORIAL_ROWS} D={d} B={b}: counts exact, sums within {rel_s:.3e} "
        f"of sum|f|, sumsq within {rel_q:.3e} of sum f^2 (float64 reference)")
    log_records(records)
    return records


def tutorial_run(ns: dict, device: str) -> tuple[list, dict, dict]:
    """The tutorial's ``train`` and ``evaluate`` on ``device`` from the
    weights of its seeded generator and its rng stream."""
    import numpy as np

    rng = np.random.default_rng(0)
    X, y = ns["make_data"](rng)
    backbone, head = ns["make_model"](torch.Generator().manual_seed(0), device)
    _, losses = ns["train"](backbone, head, X, y, ns["weights"], rng)
    overall, shots = ns["evaluate"](backbone, head, X, y)
    return losses, overall, shots


def tutorial_phase(ck, device: str = "cuda") -> dict:
    """Phase 17(b): the tutorial script run as it is on ``device``, the
    launch counts set to 0 just before and read just after: K1 and K2 on
    every step from epoch 1, K3 (its short kernel) in every stats pass.
    Then its ``train`` and ``evaluate`` on ``device`` and on the CPU, from
    the same weights and permutations: first-epoch losses and final MAEs
    within ``TUTORIAL_LOSS_RTOL`` / ``TUTORIAL_MAE_RTOL``. Returns the
    launches."""
    import runpy

    argv = sys.argv
    sys.argv = [TUTORIAL_SCRIPT, "--device", device]
    ck.reset_launch_counts()
    t0 = time.time()
    try:
        ns = runpy.run_path(TUTORIAL_SCRIPT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    launches = launch_counts(ck)
    log(f"tutorial ({time.time() - t0:.1f}s): kernel launches {launches}, K3 by kernel "
        f"{dict(ck.segment_moments.kernels)}")
    assert len(ns["y"]) == TUTORIAL_ROWS, len(ns["y"])
    steps = TUTORIAL_ROWS // TUTORIAL_BATCH
    calibrating = (TUTORIAL_EPOCHS - ns["fds_cfg"].start_smooth) * steps
    if device == "cuda":
        assert launches == launches_of(calibrate_forward=calibrating,
                                       calibrate_backward=calibrating,
                                       segment_moments=TUTORIAL_EPOCHS), launches
        assert ck.segment_moments.kernels == {"short": TUTORIAL_EPOCHS}
    (card_losses, card, card_shots), (cpu_losses, cpu, cpu_shots) = (
        tutorial_run(ns, device), tutorial_run(ns, "cpu"))
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    loss_rel = max(rel(a, b) for a, b in zip(card_losses[0], cpu_losses[0]))
    mae_rel = {r: rel(card_shots[r]["l1"], cpu_shots[r]["l1"]) for r in ("many", "median", "low")}
    mae_rel["overall"] = rel(card["l1"], cpu["l1"])
    log(f"tutorial on {device} against the CPU: first-epoch losses within {loss_rel:.3e} "
        f"relative, final MAE relative gaps {mae_rel}; {device} overall {card}, CPU overall {cpu}")
    assert all(math.isfinite(v) for e in card_losses for v in e)
    assert loss_rel <= TUTORIAL_LOSS_RTOL, loss_rel
    assert max(mae_rel.values()) <= TUTORIAL_MAE_RTOL, mae_rel
    return launches


def notebook_phase(device: str = "cuda") -> None:
    """Phase 17(c): ``tools/make_notebook.py --device`` into a temporary
    directory: every code cell executed in order, the same cells with
    outputs as the committed notebook, the first naming the device."""
    import tempfile

    from imbalanced_regression_tpu_torch.tools import make_notebook

    committed = json.loads(open(TUTORIAL_SCRIPT.replace(".py", ".ipynb")).read())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        make_notebook.main([TUTORIAL_SCRIPT, os.path.join(tmp, "tutorial.ipynb"),
                            "--device", device])
        nb = json.loads(open(os.path.join(tmp, "tutorial.ipynb")).read())
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    want = [c for c in committed["cells"] if c["cell_type"] == "code"]
    assert [c["execution_count"] for c in code] == list(range(1, len(code) + 1))
    assert [bool(c["outputs"]) for c in code] == [bool(c["outputs"]) for c in want]
    assert [c["source"] for c in code] == [c["source"] for c in want]
    first = code[0]["outputs"][0]["text"][0]
    assert first.startswith("device: ") and (device == "cpu") == (first.strip() == "device: cpu")
    log(f"notebook ({time.time() - t0:.1f}s): {len(code)} code cells executed, "
        f"{sum(bool(c['outputs']) for c in code)} with outputs; first: {first.strip()}")


def entry_phase(device: str = "cuda") -> None:
    """Phase 17(d): ``entry()``'s forward, (8, 1) and finite, against the
    same forward on the CPU (the zero batch, whose output is 0 by
    construction, and a seeded uniform batch) within ``ENTRY_TOL`` of the
    largest magnitude; host-clock and CUDA-event ms at batch 8."""
    from imbalanced_regression_tpu_torch.entry import entry

    forward, args = entry(device)
    out = forward(*args)
    torch.cuda.synchronize()
    assert out.shape == (8, 1) and out.dtype == torch.float32 and torch.isfinite(out).all(), out
    cpu_forward, cpu_args = entry("cpu")
    x = torch.rand(args[2].shape, generator=torch.Generator().manual_seed(0)) * 2 - 1
    errs = []
    for xs in (cpu_args[2], x):
        got = forward(args[0], args[1], xs.to(args[2].device)).cpu()
        want = cpu_forward(cpu_args[0], cpu_args[1], xs)
        assert torch.isfinite(got).all()
        errs.append(max_err(got, want) / max(float(want.abs().max()), 1e-30))
    assert errs[0] == 0.0 and errs[1] <= ENTRY_TOL, errs
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        forward(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    event_ms = time_ms(lambda: forward(*args), iters=reps)
    log(f"entry(): output {tuple(out.shape)} finite; against the CPU forward: zero batch equal, "
        f"seeded batch within {errs[1]:.3e} of its largest magnitude; batch 8 at 224x224 bf16: "
        f"host clock {host_ms:.3f} ms, CUDA events {event_ms:.3f} ms a call")


def phase_17(ck, cal, dev) -> tuple[dict, dict]:
    """Phase 17: the tutorial's kernel shapes, the tutorial, its notebook
    and the entry. Returns the records and the tutorial's launches."""
    t0 = time.time()
    records = tutorial_kernel_phase(ck, cal, dev)
    launches = tutorial_phase(ck)
    notebook_phase()
    entry_phase()
    log(f"tutorial and entry phase: {time.time() - t0:.1f}s")
    return records, launches


def state_digest(state) -> str:
    """A hash of the weights, BN buffers, Adam's state, the FDS state and
    the generator of a train state."""
    import hashlib

    h = hashlib.sha256()
    tensors = [*state.backbone.state_dict().values(), *state.head.state_dict().values()]
    for per_param in state.optimizer.state.values():
        tensors += [v for _, v in sorted(per_param.items()) if torch.is_tensor(v)]
    tensors += [getattr(state.fds, f.name) for f in dataclasses.fields(state.fds)
                if torch.is_tensor(getattr(state.fds, f.name))]
    tensors.append(state.generator.get_state())
    for t in tensors:
        h.update(t.detach().reshape(-1).cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def graph_side(make, graphed: bool, cell: str) -> dict:
    """One side of phase 18: ``make()`` gives (trainer, state, steps,
    stats_pass); ``steps(state, epoch, k)`` runs k steps and returns the
    state and their losses as floats. Eager where ``graphed`` is false.
    Returns the losses, the state's digest, the graph counts and the
    timing."""
    from imbalanced_regression_tpu_torch import train
    from imbalanced_regression_tpu_torch.utils.logging_tools import recorder

    real = train.graphable
    if not graphed:
        train.graphable = lambda device, mesh: False
    try:
        trainer, state, steps, stats_pass = make()
        for epoch in (0, 1):
            state = stats_pass(state, epoch)
        state, losses = steps(state, 2, 3)
        state = stats_pass(state, 2)
        state, more = steps(state, 3, 3)
        torch.cuda.synchronize()
        digest = state_digest(state)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.time_ns()
        start.record()
        state, _ = steps(state, 3, GRAPH_TIMED)
        end.record()
        end.synchronize()
        host = [sp.ms for sp in recorder.closed("step", trainer=trainer.trace_id, since_ns=t0)]
        captures = [sp.ms for sp in recorder.closed("capture", trainer=trainer.trace_id)]
        out = {"losses": losses + more, "digest": digest,
               "graph_stats": {kind: dict(n) for kind, n in trainer.graph_stats.items()},
               "capture_ms": captures[0] if captures else None,
               "host_ms": statistics.median(host),
               "period_ms": start.elapsed_time(end) / GRAPH_TIMED,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        train.graphable = real
    log(f"  {cell} {'graphed' if graphed else 'eager'}: host {out['host_ms']:.3f} ms a step, "
        f"{out['period_ms']:.3f} ms a step by CUDA events, counts {out['graph_stats']}, capture "
        f"{out['capture_ms']} ms, device peak {out['peak_gb']:.2f} GB, losses {out['losses']}")
    del trainer, state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def graph_age_cell():
    """Phase 18's age cell: AgeDB-DIR's recipe at batch 256 on random
    224x224 uint8 images, its steps through ``train_epoch``'s staging (a
    call's mean loss is its loss)."""
    import numpy as np

    from imbalanced_regression_tpu_torch.data.batching import batch_iterator
    from imbalanced_regression_tpu_torch.tasks import age
    from imbalanced_regression_tpu_torch.utils.config import parse_config

    cfg = parse_config(GRAPH_AGE_ARGV)
    rng = np.random.default_rng(18)
    n = 8 * cfg.batch_size
    size = cfg.img_size
    data = {"input": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "target": rng.integers(0, 102, (n, 1)).astype(np.float32),
            "weight": rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)}

    def make():
        trainer = age.build_trainer(cfg)
        draws = itertools.count()

        def batches(k):
            rows = np.random.default_rng(next(draws))
            return itertools.islice(itertools.cycle(
                list(batch_iterator(data, cfg.batch_size, rng=rows))), k)

        def steps(state, epoch, k):
            state, loss = trainer.train_epoch(state, batches(k), epoch)
            return state, [loss]

        def stats_pass(state, epoch):
            return trainer.fds_epoch_pass(state, batches(2), epoch)

        return trainer, trainer.init_state(0), steps, stats_pass

    return make


def graph_sts_cell():
    """Phase 18's STS-B cell: the recipe's fused BiLSTM at full width in
    bf16, batch 128 of 40-token pairs, indexed steps over a bound split of
    STS-B-DIR's size."""
    import numpy as np

    from imbalanced_regression_tpu_torch.ops.binning import bin_index_hist_np
    from imbalanced_regression_tpu_torch.tasks import stsb

    cfg = dataclasses.replace(stsb.STSConfig(), **GRAPH_STS_RECIPE)
    rng = np.random.default_rng(18)
    n, width = GRAPH_STS_ROWS, cfg.max_seq_len

    def column():
        lengths = rng.integers(5, width + 1, n)
        mask = (np.arange(width)[None] < lengths[:, None]).astype(np.float32)
        ids = rng.integers(4, GRAPH_STS_VOCAB, (n, width)).astype(np.int32)
        return ids * mask.astype(np.int32), mask

    (t1, m1), (t2, m2) = column(), column()
    scores = np.round(5.0 * rng.beta(2.0, 5.0, n), 3).astype(np.float32)
    data = {"input": {"tokens1": t1, "mask1": m1, "tokens2": t2, "mask2": m2},
            "target": scores[:, None], "bucket_idx": bin_index_hist_np(scores, cfg.bucket_num, 0),
            "weight": rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)}
    table = rng.normal(0.0, 0.5, (GRAPH_STS_VOCAB, cfg.d_word)).astype(np.float32)

    def make():
        trainer = stsb.build_sts_trainer(cfg, GRAPH_STS_VOCAB, table)
        trainer.bind_device_data(data)
        draws = itertools.count()

        def index_batches(k):
            order = np.random.default_rng(next(draws)).permutation(n)
            return [order[i * cfg.batch_size:(i + 1) * cfg.batch_size] for i in range(k)]

        def steps(state, epoch, k):
            losses = []
            for idx in index_batches(k):
                state, loss, _ = trainer.train_step_indexed(state, idx, epoch)
                losses.append(loss)
            return state, [float(x) for x in losses]

        def stats_pass(state, epoch):
            return trainer.fds_epoch_pass_indexed(state, iter(index_batches(2)), epoch)

        return trainer, trainer.init_state(0), steps, stats_pass

    return make


def graph_phase() -> dict:
    """Phase 18: the graphed step against the eager one at both cells'
    shapes; bit-equal, and timed. Returns the timings by cell."""
    records = {}
    with cudnn_determinism(True):
        for cell, make in (("stsb-bilstm.b128", graph_sts_cell()),
                           ("age-r50-agedb.b256", graph_age_cell())):
            eager = graph_side(make, False, cell)
            graphed = graph_side(make, True, cell)
            assert graphed["losses"] == eager["losses"], (graphed["losses"], eager["losses"])
            assert graphed["digest"] == eager["digest"], f"{cell}: graphed and eager states differ"
            replays = graphed["graph_stats"]["step"]["replays"]
            assert replays == 5 + GRAPH_TIMED, graphed["graph_stats"]
            records[cell] = {side: {k: r[k] for k in ("host_ms", "period_ms", "capture_ms", "peak_gb")}
                             for side, r in (("eager", eager), ("graphed", graphed))}
            log(f"graph phase {cell}: bit-equal; {json.dumps(records[cell])}")
    return records


def profile_window(name: str, trainer, state, steps_in: list, epoch: int, steps: int,
                   indexed: bool = False, staged: bool = False) -> None:
    """Where the time of a train step goes: the last ``steps`` of
    ``steps_in`` under ``torch.profiler``, after the others as warm-up.
    Prints the step time, the device's busy share and the kernels that take
    the most device time, and writes the timeline to
    ``runs/chip_smoke/trace_<name>.json``. ``indexed``: ``steps_in`` are
    index batches for ``train_step_indexed`` (STS-B pairs); ``staged``: the
    steps run through ``train_epoch``, whose prefetch thread stages each
    batch through pinned memory on a side stream (the copies then overlap
    the steps, and count in the device's busy time beside them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = trainer.train_step_indexed if indexed else trainer.train_step

    def run(batches):
        if staged:
            trainer.train_epoch(state, batches, epoch)
        for b in [] if staged else batches:
            step(state, b, epoch)

    images = len(steps_in[0]) if indexed else len(steps_in[0]["target"])
    unit = "pairs/s" if indexed else "img/s"
    run(steps_in[:-steps])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps_in[-steps:])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device activity only (kernels and copies), grouped by name
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        # user annotations (e.g. the optimizer step's range) also appear on
        # the device timeline, spanning kernels counted on their own
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    device_ms = sum(sum(v) for v in by_name.values()) / steps
    log(f"profile {name}: {wall_ms:.2f} ms/step on the host clock ({images * 1e3 / wall_ms:.1f} "
        f"{unit}), device busy {device_ms:.2f} ms/step ({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(len(v) for v in by_name.values()) // steps} device activities/step")
    top = sorted(by_name.items(), key=lambda kv: sum(kv[1]), reverse=True)
    for kernel, times in top[:15]:
        log(f"  {sum(times) / steps:8.3f} ms/step  x{len(times) // steps:<4d} {kernel[:100]}")
    fds_ms = sum(sum(v) for k, v in by_name.items() if "calibrate_kernel" in k or "moments_kernel" in k)
    log(f"  FDS kernels: {fds_ms / steps:.4f} ms/step")
    copies = {k: v for k, v in by_name.items() if "Memcpy" in k}
    log(f"  host-to-device and other copies: {sum(sum(v) for v in copies.values()) / steps:.4f} "
        f"ms/step ({sorted(k[:60] for k in copies)})")
    upsample = {k: v for k, v in by_name.items() if "upsample" in k}
    log(f"  upsample kernels: {sum(sum(v) for v in upsample.values()) / steps:.4f} ms/step "
        f"({sorted(k[:60] for k in upsample)})")
    os.makedirs("runs/chip_smoke", exist_ok=True)
    prof.export_chrome_trace(f"runs/chip_smoke/trace_{name}.json")


def profile_phase(steps: int = 5) -> None:
    """Profiled windows of ``steps`` train steps with calibration on (epoch
    2, after two stats passes), after three warm-up steps: the age path's
    trainer (batch 64, 224x224), the AgeDB-DIR path's (batch 256 of uint8
    images through ``train_epoch``'s staging), the depth path's (batch 32,
    228x304) and the STS-B path's (batch 128, indexed, on the phase-11
    corpus)."""
    import numpy as np

    from imbalanced_regression_tpu_torch.data.batching import batch_iterator
    from imbalanced_regression_tpu_torch.tasks import age, nyud2
    from imbalanced_regression_tpu_torch.utils.config import parse_config

    cfg = parse_config(MAIN_ARGV)
    train, _, _, _ = age.build_data(cfg)
    trainer = age.build_trainer(cfg)
    state = trainer.init_state(0)
    batches = lambda k: list(batch_iterator(train, N_MAIN, rng=np.random.default_rng(k)))  # noqa: E731
    for epoch in (0, 1):  # two stats passes: a non-trivial snapshot for epoch 2
        state = trainer.fds_epoch_pass(state, batches(epoch)[:2], epoch)
    profile_window("age", trainer, state, batches(2)[: 3 + steps], 2, steps)

    # the AgeDB-DIR step: batch 256 of uint8 images, staged by train_epoch
    acfg = parse_config(AGEDB_ARGV)
    trainer = age.build_trainer(acfg)
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    n = AGEDB_BATCH * (3 + steps)
    data = {"input": rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8),
            "target": rng.integers(0, 102, (n, 1)).astype(np.float32),
            "weight": np.ones((n, 1), np.float32)}
    batches = list(batch_iterator(data, AGEDB_BATCH, shuffle=False))
    for epoch in (0, 1):
        state = trainer.fds_epoch_pass(state, batches[:2], epoch)
    profile_window("agedb", trainer, state, batches, 2, steps, staged=True)
    del trainer, state, data, batches

    dcfg = nyud2.parse_nyud_config(DEPTH_ARGV)
    train, fds_subset, _ = nyud2.build_data(dcfg)
    trainer = nyud2.build_nyud_trainer(dcfg)
    state = trainer.init_state(0)
    batches = lambda k: list(batch_iterator(train, DEPTH_BATCH, rng=np.random.default_rng(k)))  # noqa: E731
    for epoch in (0, 1):
        state = trainer.fds_epoch_pass(
            state, batch_iterator(fds_subset, DEPTH_BATCH, shuffle=False), epoch)
    profile_window("depth", trainer, state, (batches(2) + batches(3))[: 3 + steps], 2, steps)
    del trainer, state

    from imbalanced_regression_tpu_torch.data.batching import index_iterator
    from imbalanced_regression_tpu_torch.data.stsb import load_stsb_datasets
    from imbalanced_regression_tpu_torch.tasks import stsb

    scfg = stsb.parse_sts_config(STS_ARGV)
    train, _, _, emb, vocab = load_stsb_datasets(scfg.data_dir, scfg)
    trainer = stsb.build_sts_trainer(scfg, len(vocab), emb)
    state = trainer.init_state(0)
    trainer.bind_device_data(train)
    n = len(train["target"])
    batches = lambda k: list(index_iterator(n, STS_BATCH, rng=np.random.default_rng(k)))  # noqa: E731
    for epoch in (0, 1):
        state = trainer.fds_epoch_pass_indexed(state, batches(epoch)[:2], epoch)
    profile_window("sts", trainer, state, batches(2)[: 3 + steps], 2, steps, indexed=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", action="store_true",
                   help="also profile train steps of both paths (device time by kernel)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from imbalanced_regression_tpu_torch.ops import calibrate as cal
    from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
    from imbalanced_regression_tpu_torch.tasks.stsb import parse_sts_config
    from imbalanced_regression_tpu_torch.train import set_numerics

    set_numerics()
    t0 = time.time()
    ck.load_library()
    log(f"kernel build+load: {time.time() - t0:.1f}s -> {ck.library_path()}")
    for line in ck.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda:0")
    floor = graph_floor_ms(dev)
    lstm_records = lstm_cell_phase(ck, dev)
    moe_records = moe_dispatch_phase(ck, dev)
    age_records, bench_records, depth_records, sts_records, agedb_records = kernel_phase(
        ck, cal, dev)
    age_launches = main_path_phase(ck)
    depth_launches, depth_result = depth_path_phase(ck)
    stats_launches, stats_records = depth_stats_phase(ck, depth_result)
    del depth_result  # the depth model and its optimizer state
    # phase 6 counts for K4 only: K3's launch there is a comparison
    stats_launches = {k: v if k == "segment_moments_v2" else 0 for k, v in stats_launches.items()}
    depth_records.update(stats_records)
    resize_phase(dev)
    resume_launches, stage1 = age_resume_phase(ck)
    rrt_launches = rrt_phase(ck, stage1)
    depth_resume_launches, depth_store = depth_resume_phase(ck)
    t0 = time.time()
    write_sts_corpus()
    log(f"STS-B corpus and GloVe file written: {time.time() - t0:.1f}s")
    sts_argv = with_root(STS_ARGV, f"{RESUME_ROOT}/sts_full")
    sts_launches, sts_result = sts_path_phase(ck, sts_argv)
    del sts_result["trainer"], sts_result["state"]
    sts_resume_launches = sts_resume_phase(
        ck, sts_result, store_of(parse_sts_config(sts_argv)))
    del sts_result
    agedb_launches, legs_launches = agedb_phase(ck)
    serving = serving_phase(ck, stage1, depth_store, sts_argv)
    shutil.rmtree(RESUME_ROOT)
    dp_launches = dp_phase(ck, cal, dev)
    bench_launches, sweep_launches, sts_flax_launches = tools_phase(ck)
    tutorial_records, tutorial_launches = phase_17(ck, cal, dev)
    graphs = graph_phase()
    moe_launches = sts_moe_phase(ck)
    shutil.rmtree(RESUME_ROOT)
    if args.profile:
        profile_phase()
    shutil.rmtree(STS_DIR)

    # launches by phase: the age shape's records count phases 4, 8, 9,
    # 13's legs (batch 64), 15's ranks (64 rows each) and 16's sweep, the
    # bench batch's 16's bench, the depth shape's phases 5, 6 (K4) and 10,
    # the STS-B shape's 11, 12 and 16's per-direction run, the AgeDB
    # batch's 13, the tutorial's shapes 17, the LSTM cell's 11 and 12, the
    # MoE dispatch's 19
    age_phases = {"4": age_launches, "8": resume_launches, "9": rrt_launches,
                  "13": legs_launches, "15": dp_launches, "16": sweep_launches}
    bench_phases = {"16": bench_launches}
    depth_phases = {"5": depth_launches, "6": stats_launches, "10": depth_resume_launches}
    sts_phases = {"11": sts_launches, "12": sts_resume_launches, "16": sts_flax_launches}
    agedb_phases = {"13": agedb_launches}
    kernels = []
    for records, phases in ((age_records, age_phases), (bench_records, bench_phases),
                            (depth_records, depth_phases), (sts_records, sts_phases),
                            (agedb_records, agedb_phases),
                            (tutorial_records, {"17": tutorial_launches}),
                            (lstm_records, {"11": sts_launches, "12": sts_resume_launches}),
                            (moe_records, {"19": moe_launches})):
        for key, r in records.items():
            name = key.split()[0]  # "segment_moments runs": K3 on the run-structured index
            by_phase = {p: n.get(name, 0) for p, n in phases.items()}
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"imbalanced_regression_tpu_torch/csrc/{SOURCES[name]}",
                "replaces": REPLACES[name], "shape": r["shape"], "launches": sum(by_phase.values()),
                "launches_by_phase": by_phase,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "graph_floor_ms": floor, "library_ms": r["library_ms"]})
    log(json.dumps({"serving": serving}))
    log(json.dumps({"graphed_step": graphs}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
