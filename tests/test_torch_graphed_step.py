"""The graphed train step (``train.py`` ``StepGraphs``): where it engages
(CUDA without a mesh, outside anomaly mode; a key's first step runs
eagerly), its key (the batch's shapes and dtypes, smoothing, the lr), the
graphs dropped by ``restore_state``, the optimizer's ``load_state_dict``
and a new ``init_state``, the ``capture`` and ``replay`` spans and the
counts in ``Trainer.epoch_log`` and the STS-B driver's ``metrics.jsonl``
(the step's and the stats pass's).

On the CPU a stand-in graph (``FakeGraph``) replays by running the
captured update again on the graph's static inputs and tables, so the
key, the copies into the static tensors, the refreshed FDS tables and the
cloned outputs are held against eager steps there. On the card (the
``cuda`` tests) a captured CUDA graph is held bit for bit against eager
steps: the fused BiLSTM with dropout and a ResNet with augment, FDS
smoothing and each remat mode, across a stats pass; two batch shapes
alternating in one pool; a checkpoint written after graphed steps.

This file imports neither jax nor the JAX package, so its ``cuda`` tests
also run on a machine with only PyTorch:

    python -m pytest --noconftest tests/test_torch_graphed_step.py -q -m cuda
"""

import json
import os

import numpy as np
import pytest
import torch

from imbalanced_regression_tpu_torch import train
from imbalanced_regression_tpu_torch.data.augment import random_crop_flip_normalize
from imbalanced_regression_tpu_torch.data.batching import batch_iterator
from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.models.bilstm_pair import PairBiLSTMEncoder
from imbalanced_regression_tpu_torch.models.resnet import RegressionHead, ResNetBasicBackbone
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    graphable,
    restore_state,
    snapshot_state,
)
from imbalanced_regression_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from imbalanced_regression_tpu_torch.utils.logging_tools import recorder, step_log

ROWS, IMG = 8, 32


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads on both sides of every comparison (the suite
    runs in several worker processes at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none. Decided
    when the test runs, never at import, so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


@pytest.fixture
def deterministic():
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


class FakeGraph:
    """A CUDA graph's stand-in on the CPU: ``replay`` runs the captured
    update again (on the graph's static inputs and tables) and writes its
    loss and predictions into the static outputs."""

    def __init__(self, run, outputs):
        self.run, self.outputs = run, outputs

    def replay(self):
        for static, t in zip(self.outputs, self.run()):
            static.resize_(t.shape).copy_(t)


def _fake_record(self, generator, run):
    outputs = (torch.empty(0), torch.empty(0))
    return FakeGraph(run, outputs), outputs


@pytest.fixture
def fake_graphs(monkeypatch):
    """Steps on the CPU take the graphed path, with :class:`FakeGraph` for
    the captured graph."""
    monkeypatch.setattr(train, "graphable", lambda device, mesh: mesh is None)
    monkeypatch.setattr(train.StepGraphs, "_record", _fake_record)


def eager(monkeypatch):
    monkeypatch.setattr(train, "graphable", lambda device, mesh: False)


# ---------------------------------------------------------------- models
def resnet_trainer(device, remat=None, schedule=(60, 80), start_smooth=1):
    """A ResNet of one BasicBlock a stage on 32x32 uint8 images, with the
    age suites' augment and FDS calibrating from ``start_smooth``."""
    return Trainer(ResNetBasicBackbone(stage_sizes=(1, 1), width=8, dtype=torch.float32,
                                       remat=remat),
                   RegressionHead(16), TrainerConfig(loss="l1", lr=1e-3, schedule=schedule),
                   fds_config=FDSConfig.for_age(feature_dim=16, bucket_num=100,
                                                start_smooth=start_smooth),
                   train_augment=random_crop_flip_normalize, device=device)


def resnet_data(n=96, seed=3):
    rng = np.random.default_rng(seed)
    return {"input": rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8),
            "target": rng.integers(1, 99, (n, 1)).astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)}


def bilstm_trainer(device, vocab=60, d_hid=16):
    """STS-B's fused BiLSTM pair encoder (two layers, dropout 0.2 on the
    embeddings and the LSTM output) in bf16, its recipe's Adam, clip and
    FDS on the pair feature."""
    encoder = PairBiLSTMEncoder(vocab, d_word=16, d_hid=d_hid, dropout=0.2, dropout_embs=0.2,
                                train_words=False, dtype=torch.bfloat16)
    return Trainer(encoder, RegressionHead(8 * d_hid),
                   TrainerConfig(loss="mse", lr=1e-3, clip_grad_norm=5.0, target_scale=5.0,
                                 schedule=()),
                   fds_config=FDSConfig.for_sts(feature_dim=8 * d_hid, bucket_num=50,
                                                start_smooth=1),
                   device=device)


def bilstm_data(n=96, steps=12, vocab=60, seed=4):
    rng = np.random.default_rng(seed)

    def column():
        lengths = rng.integers(2, steps + 1, n)
        mask = (np.arange(steps)[None] < lengths[:, None]).astype(np.float32)
        return rng.integers(2, vocab, (n, steps)).astype(np.int32) * mask.astype(np.int32), mask

    (t1, m1), (t2, m2) = column(), column()
    scores = rng.uniform(0, 5, n).astype(np.float32)
    return {"input": {"tokens1": t1, "mask1": m1, "tokens2": t2, "mask2": m2},
            "target": scores[:, None], "bucket_idx": np.minimum(scores * 10, 49).astype(np.int32),
            "weight": rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)}


def run_across_a_stats_pass(trainer, data, rows=ROWS, indexed=False):
    """Stats passes at epochs 0 and 1, three steps at epoch 2, a stats pass
    at epoch 2 (new tables for K1/K2), three steps at epoch 3. Returns the
    state and each step's (loss, predictions)."""
    state = trainer.init_state(0)
    rng = np.random.default_rng(7)
    order = rng.permutation(len(data["target"]))
    batches = [order[i * rows:(i + 1) * rows] for i in range(len(order) // rows)]
    take = lambda idx: {k: (take_nested(v, idx)) for k, v in data.items()}  # noqa: E731
    if indexed:
        trainer.bind_device_data(data)
    outs = []

    def stats_pass(epoch, pass_batches):
        if indexed:
            return trainer.fds_epoch_pass_indexed(state, iter(pass_batches), epoch)
        return trainer.fds_epoch_pass(state, iter([take(b) for b in pass_batches]), epoch)

    def step(idx, epoch):
        if indexed:
            return trainer.train_step_indexed(state, idx, epoch)
        return trainer.train_step(state, take(idx), epoch)

    for epoch in (0, 1):
        state = stats_pass(epoch, batches[2 * epoch:2 * epoch + 2])
    for k in range(6):
        epoch = 2 if k < 3 else 3
        if k == 3:
            state = stats_pass(2, batches[4:6])
        state, loss, pred = step(batches[6 + k], epoch)
        outs.append((loss, pred))
    return state, outs


def take_nested(v, idx):
    return {k: take_nested(x, idx) for k, x in v.items()} if isinstance(v, dict) else v[idx]


def assert_states_equal(got, want):
    for part in ("backbone", "head"):
        g, w = getattr(got, part).state_dict(), getattr(want, part).state_dict()
        for k in w:
            assert torch.equal(g[k], w[k]), f"{part}.{k}"
    gs, ws = got.optimizer.state_dict()["state"], want.optimizer.state_dict()["state"]
    assert gs.keys() == ws.keys()
    for i in ws:
        for k in ws[i]:
            assert torch.equal(gs[i][k].cpu(), ws[i][k].cpu()), (i, k)
    for f in ("running_mean", "running_var", "running_mean_last_epoch", "running_var_last_epoch",
              "smoothed_mean_last_epoch", "smoothed_var_last_epoch", "num_samples_tracked"):
        assert torch.equal(getattr(got.fds, f), getattr(want.fds, f)), f
    assert got.step == want.step
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


def assert_outputs_equal(got, want):
    for (gl, gp), (wl, wp) in zip(got, want, strict=True):
        assert torch.equal(gl, wl) and torch.equal(gp, wp)
    # each step's loss is a tensor of its own (no two alias the graph's output)
    losses = [loss for loss, _ in got]
    assert len({loss.data_ptr() for loss in losses}) == len(losses)
    assert len({float(loss) for loss in losses}) == len(losses)


def kinds(trainer):
    """Each step span's kind: ``eager``, ``capture`` (captured, then
    replayed) or ``replay``."""
    spans = recorder.closed("step", "capture", "replay", trainer=trainer.trace_id)
    inner = {}
    for s in spans:
        if s.name != "step":
            inner.setdefault(id(s.parent), s.name)  # a capture closes before its replay
    return [inner.get(id(s), "eager") for s in spans if s.name == "step"]


# ------------------------------------------------------------ CPU tests
@pytest.mark.parametrize("device,mesh,anomaly,want", [
    ("cuda", None, False, True), ("cpu", None, False, False), ("cuda", object(), False, False),
    ("cuda", None, True, False)])
def test_graphable_only_on_cuda_without_mesh_or_anomaly(device, mesh, anomaly, want):
    with torch.autograd.set_detect_anomaly(anomaly):
        assert graphable(torch.device(device), mesh) is want


def test_cpu_steps_run_eagerly():
    trainer = resnet_trainer("cpu")
    state, _ = run_across_a_stats_pass(trainer, resnet_data())
    assert trainer.graph_stats["step"] == {"captures": 0, "replays": 0, "eager": 6}
    assert state.graphs.entries == {} and kinds(trainer) == ["eager"] * 6
    assert not recorder.closed("capture", "replay", trainer=trainer.trace_id)


@pytest.mark.parametrize("family", ["resnet", "bilstm"])
def test_graphed_steps_equal_eager_across_a_stats_pass(family, fake_graphs, monkeypatch):
    """Stand-in graphs: the steps after the stats pass read its new tables,
    each step's batch reaches the static inputs, and each returned loss
    and prediction is the step's own."""
    make, data, indexed = ((resnet_trainer, resnet_data(), False) if family == "resnet"
                           else (bilstm_trainer, bilstm_data(), True))
    graphed = make("cpu")
    got_state, got = run_across_a_stats_pass(graphed, data, indexed=indexed)
    assert graphed.graph_stats["step"] == {"captures": 1, "replays": 5, "eager": 1}
    assert kinds(graphed) == ["eager", "capture", "replay", "replay", "replay", "replay"]
    eager(monkeypatch)
    plain = make("cpu")
    want_state, want = run_across_a_stats_pass(plain, data, indexed=indexed)
    assert plain.graph_stats["step"] == {"captures": 0, "replays": 0, "eager": 6}
    assert_outputs_equal(got, want)
    assert_states_equal(got_state, want_state)


def test_key_is_shapes_smoothing_and_lr(fake_graphs):
    """A new key's first step runs eagerly and its second captures: the
    first epochs before ``start_smooth`` (smoothing off), the epochs from
    it, the lr's milestone, a batch of another size; a key seen before
    replays."""
    trainer = resnet_trainer("cpu", schedule=(2,))
    state = trainer.init_state(0)
    data = resnet_data()
    batch = lambda lo, n=ROWS: {k: v[lo:lo + n] for k, v in data.items()}  # noqa: E731
    plan = [(0, ROWS)] * 3 + [(1, ROWS)] * 2 + [(2, ROWS)] * 2 + [(2, 6)] * 2 + [(2, ROWS)]
    for i, (epoch, n) in enumerate(plan):
        state, _, _ = trainer.train_step(state, batch(i * ROWS, n), epoch)
    assert kinds(trainer) == ["eager", "capture", "replay", "eager", "capture", "eager",
                              "capture", "eager", "capture", "replay"]
    keys = {(key[0][0][1][0], key[1], key[2]) for key in state.graphs.entries}
    full, six, lr2 = (ROWS, IMG, IMG, 3), (6, IMG, IMG, 3), 1e-3 * 0.1 ** 1
    assert keys == {(full, False, 1e-3), (full, True, 1e-3), (full, True, lr2), (six, True, lr2)}
    assert trainer.graph_stats["step"] == {"captures": 4, "replays": 6, "eager": 4}


def test_graphs_dropped_on_restore_optimizer_load_and_init_state(fake_graphs):
    trainer = resnet_trainer("cpu")
    state = trainer.init_state(0)
    b = {k: v[:ROWS] for k, v in resnet_data().items()}

    def steps(k):
        nonlocal state
        for _ in range(k):
            state, _, _ = trainer.train_step(state, b, 1)

    steps(2)
    assert len(state.graphs.entries) == 1
    restore_state(state, snapshot_state(state))
    assert state.graphs.entries == {} and state.graphs.warmed == set()
    steps(2)
    assert len(state.graphs.entries) == 1
    state.optimizer.load_state_dict(state.optimizer.state_dict())
    assert state.graphs.entries == {} and state.graphs.tables is None
    steps(2)
    old = state
    state = trainer.init_state(1)
    assert old.graphs.entries == {} and state.graphs is not old.graphs
    steps(1)
    assert kinds(trainer) == ["eager", "capture"] * 3 + ["eager"]


def test_spans_and_step_log_report_the_graphed_steps(fake_graphs):
    trainer = resnet_trainer("cpu")
    state = trainer.init_state(0)
    data = resnet_data()
    state, _ = trainer.train_epoch(state, batch_iterator(data, ROWS, rng=np.random.default_rng(0)),
                                   4)
    spans = recorder.closed(trainer=trainer.trace_id)
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == len(data["target"]) // ROWS
    capture, = [s for s in spans if s.name == "capture"]
    replays = [s for s in spans if s.name == "replay"]
    assert capture.parent is steps[1] and [s.parent for s in replays] == steps[1:]
    assert all(s.epoch == 4 and s.start_ns >= s.parent.start_ns and s.end_ns <= s.parent.end_ns
               for s in replays + [capture])
    log = trainer.epoch_log()
    assert (log["graph_captures"], log["graph_replays"], log["eager_steps"]) == (
        1, len(steps) - 1, 1)
    assert "graph_captures" not in step_log(spans)


@pytest.fixture(scope="module")
def sts_driver_runs(tmp_path_factory):
    """The STS-B driver run eagerly on the CPU, then with stand-in graphs:
    each run's result and the tags it logged at its last validation
    check."""
    from torch_stsb_tiny import write_tiny_tsvs

    from imbalanced_regression_tpu_torch.tasks import stsb

    tmp = tmp_path_factory.mktemp("sts_driver")
    write_tiny_tsvs(str(tmp / "data"), n_train=40, n_eval=10)

    def run(root):
        argv = ["--data_dir", str(tmp / "data"), "--device", "cpu", "--d_word", "8",
                "--d_hid", "8", "--n_layers_enc", "1", "--max_seq_len", "10", "--batch_size", "8",
                "--val_interval", "6", "--max_vals", "2", "--lr", "1e-2", "--glove", "0",
                "--fds", "--lds", "--reweight", "inverse", "--store_root", str(tmp / root),
                "--cache_dir", str(tmp / "cache")]
        result = stsb.main(argv)
        store = os.path.join(str(tmp / root), stsb.parse_sts_config(argv).derived_store_name())
        with open(os.path.join(store, "metrics.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        return result, {r["tag"]: r["value"] for r in logged if r["step"] == 2}

    # a module-scoped fixture runs before the autouse thread count is set
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        plain = run("eager")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(train, "graphable", lambda device, mesh: mesh is None)
            mp.setattr(train.StepGraphs, "_record", _fake_record)
            graphed = run("graphed")
    finally:
        torch.set_num_threads(before)
    return plain, graphed


@pytest.mark.parametrize("kind", ["step", "pass"])
def test_sts_driver_logs_the_graph_counts(kind, sts_driver_runs):
    """The STS-B driver's ``metrics.jsonl`` counts eager steps and
    stats-pass batches on the CPU; with stand-in graphs, the steps'
    warm-ups, captures and replays, and the pass's one eager batch and
    replays of the rest; the two runs' results are equal."""
    (plain, plain_log), (graphed, log) = sts_driver_runs
    if kind == "step":
        tags = ("graph_captures", "graph_replays", "eager_steps")
        assert tuple(plain_log[t] for t in tags) == (0, 0, 12)
        # 12 steps; smoothing from epoch 1 on: two keys, each warmed, captured
        assert tuple(log[t] for t in tags) == (2, 10, 2)
    else:
        batches = plain_log["pass_eager_batches"]
        assert plain_log["pass_graph_replays"] == 0 and batches >= 2
        assert (log["pass_graph_replays"], log["pass_eager_batches"]) == (batches - 1, 1)
    assert graphed["test"] == plain["test"] and graphed["val_history"] == plain["val_history"]


def test_optimizer_load_keeps_the_trainers_form():
    """A state dict written in Adam's fused capturable form (as on the
    card) loads into a CPU trainer in its own form: neither fused nor
    capturable, the step counts float32 on the parameters' device; the
    graphs go."""
    trainer = resnet_trainer("cpu")
    state = trainer.init_state(0)
    b = {k: v[:ROWS] for k, v in resnet_data().items()}
    state, _, _ = trainer.train_step(state, b, 1)
    sd = state.optimizer.state_dict()
    for group in sd["param_groups"]:
        group["capturable"], group["fused"] = True, True
    state.graphs.warmed.add("a key")
    state.optimizer.load_state_dict(sd)
    assert state.graphs.warmed == set()
    assert all(g["capturable"] is False and g["fused"] is None
               for g in state.optimizer.param_groups)
    steps = [s["step"] for s in state.optimizer.state.values()]
    assert steps and all(t.device.type == "cpu" and t.dtype == torch.float32 for t in steps)
    state, loss, _ = trainer.train_step(state, b, 1)
    assert torch.isfinite(loss)


# ----------------------------------------------------------- card tests
def _launches():
    return [fn.launches for fn in ck.KERNEL_WRAPPERS]


@pytest.mark.cuda
@pytest.mark.parametrize("family,remat", [("bilstm", None), ("resnet", None),
                                          ("resnet", "block"), ("resnet", "conv_outs")])
def test_graphed_steps_bit_equal_to_eager_on_card(cuda_device, deterministic, monkeypatch,
                                                  family, remat):
    """Six steps across a stats pass, captured and replayed, against six
    eager steps from the same seeds: losses, predictions, parameters, Adam's
    moments and step counts, BN buffers, FDS state and the generator bit
    for bit; the graph's K1/K2 launches counted as the eager calls count
    theirs."""
    if family == "bilstm":
        make, data, indexed = (lambda d: bilstm_trainer(d)), bilstm_data(), True
    else:
        make, data, indexed = (lambda d: resnet_trainer(d, remat=remat)), resnet_data(), False
    ck.reset_launch_counts()
    graphed = make(cuda_device)
    got_state, got = run_across_a_stats_pass(graphed, data, indexed=indexed)
    torch.cuda.synchronize()
    got_launches = _launches()
    assert graphed.graph_stats["step"] == {"captures": 1, "replays": 5, "eager": 1}
    eager(monkeypatch)
    ck.reset_launch_counts()
    plain = make(cuda_device)
    want_state, want = run_across_a_stats_pass(plain, data, indexed=indexed)
    torch.cuda.synchronize()
    assert got_launches == _launches() and got_launches[:2] == [6, 6]
    assert_outputs_equal(got, want)
    assert_states_equal(got_state, want_state)
    # the graph's gradients are the parameters' after a replay
    for (pg, pw) in zip(got_state.head.parameters(), want_state.head.parameters()):
        assert torch.equal(pg.grad, pw.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("factored", [False, True])
def test_depth_steps_bit_equal_to_eager_on_card(cuda_device, deterministic, monkeypatch,
                                                factored):
    """The NYUD2 trainer (the encoder-decoder in bf16, the photometric
    augment, the per-pixel LDS weights, FDS on the per-pixel hook, Adam
    with L2) at 64x96, graphed against eager across a stats pass; with
    K1's factored form too, whose scratch table the graph's pool serves."""
    from imbalanced_regression_tpu_torch.data.nyud2 import (
        make_pixel_weight_fn,
        nyud2_train_photometric,
        synthetic_depth_dataset,
    )
    from imbalanced_regression_tpu_torch.models.depth_encdec import (
        DepthEncoderDecoder,
        DepthHead,
        depth_feature_dim,
    )

    if factored:  # K1's factored form from the first row on
        monkeypatch.setattr(ck, "FACTORED_ROWS_PER_BUCKET", 0)
    ck.calibrate_plan.cache_clear()

    def make(device):
        feat = depth_feature_dim(8 * 32)
        return Trainer(DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8,
                                           dtype=torch.bfloat16),
                       DepthHead(feat),
                       TrainerConfig(loss="mse", lr=1e-4, adam_weight_decay=1e-4,
                                     schedule=(5,)),
                       fds_config=FDSConfig.for_depth(feature_dim=feat),
                       train_augment=nyud2_train_photometric,
                       weight_fn=make_pixel_weight_fn(np.linspace(0.5, 2.0, 100)),
                       device=device)

    data = synthetic_depth_dataset(48, seed=6)
    ck.reset_launch_counts()
    graphed = make(cuda_device)
    got_state, got = run_across_a_stats_pass(graphed, data, rows=4)
    got_launches = _launches()
    assert graphed.graph_stats["step"] == {"captures": 1, "replays": 5, "eager": 1}
    eager(monkeypatch)
    ck.reset_launch_counts()
    want_state, want = run_across_a_stats_pass(make(cuda_device), data, rows=4)
    assert got_launches == _launches()
    assert_outputs_equal(got, want)
    assert_states_equal(got_state, want_state)
    ck.calibrate_plan.cache_clear()  # the monkeypatched constant goes back after the test


@pytest.mark.cuda
def test_alternating_shapes_share_the_pool_on_card(cuda_device, deterministic, monkeypatch):
    """Batches of 8 and 6 rows in turn: two graphs in one memory pool, each
    replayed after the other, bit-equal to eager steps."""
    data = resnet_data()
    batches = [{k: v[i * ROWS:i * ROWS + (ROWS if i % 2 == 0 else 6)] for k, v in data.items()}
               for i in range(8)]

    def run(trainer):
        state = trainer.init_state(0)
        state = trainer.fds_epoch_pass(state, iter(batches[:2]), 0)
        state = trainer.fds_epoch_pass(state, iter(batches[2:4]), 1)
        outs = []
        for b in batches[2:]:
            state, loss, pred = trainer.train_step(state, b, 2)
            outs.append((loss, pred))
        return state, outs

    graphed = resnet_trainer(cuda_device)
    got_state, got = run(graphed)
    assert kinds(graphed) == ["eager", "eager", "capture", "capture", "replay", "replay"]
    eager(monkeypatch)
    want_state, want = run(resnet_trainer(cuda_device))
    assert_outputs_equal(got, want)
    assert_states_equal(got_state, want_state)


@pytest.mark.cuda
def test_checkpoint_after_graphed_steps_round_trips_on_card(cuda_device, deterministic,
                                                            tmp_path):
    """A checkpoint saved after graphed steps restores bit-exact (Adam's
    step counts on the card included), and the restored state's next steps
    (an eager warm-up, a capture, a replay) equal the uninterrupted run's."""
    data = resnet_data()
    b = lambda i: {k: v[i * ROWS:(i + 1) * ROWS] for k, v in data.items()}  # noqa: E731
    trainer = resnet_trainer(cuda_device, start_smooth=0)
    state = trainer.init_state(0)
    state = trainer.fds_epoch_pass(state, iter([b(0), b(1)]), 0)
    for i in range(3):
        state, _, _ = trainer.train_step(state, b(2 + i), 1)
    save_checkpoint(str(tmp_path), state, 1, 1.0, is_best=False)
    saved = {i: {k: v.clone() for k, v in s.items()} for i, s in state.optimizer.state.items()}
    after = [float(trainer.train_step(state, b(5 + i), 1)[1]) for i in range(3)]

    other = resnet_trainer(cuda_device, start_smooth=0)
    restored, _, _ = restore_checkpoint(str(tmp_path), other.init_state(9))
    for p, s in restored.optimizer.state.items():
        assert s["step"].device == p.device
    for (p, s), want in zip(restored.optimizer.state.items(), saved.values()):
        for k in want:
            assert torch.equal(s[k], want[k]), k
    resumed = [float(other.train_step(restored, b(5 + i), 1)[1]) for i in range(3)]
    assert resumed == after
    assert kinds(other) == ["eager", "capture", "replay"]
    assert_states_equal(restored, state)
