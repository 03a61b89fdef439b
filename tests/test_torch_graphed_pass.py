"""The graphed FDS stats pass (``train.py`` ``Trainer._graphed``, kind ``pass``):
where it engages (where the step is graphed: CUDA without a mesh, outside
anomaly mode), its key (``("pass", ...)`` and the shapes and dtypes of the
batch's input, target and bucket index), the eager, capture and replay
batches of set-up-sized and window-sized passes, the ``pass_batch``,
``pass_capture`` and ``pass_replay`` spans, ``graph_stats["pass"]`` and
the ``Trainer.epoch_log`` keys, and the pass graphs dropped with the
step's. The STS-B driver's logged pass counts are a case of
``test_sts_driver_logs_the_graph_counts`` in ``test_torch_graphed_step.py``.

On the CPU a stand-in graph (``FakeGraph`` of
``test_torch_graphed_step.py``) replays by running the captured batch
again on the graph's static inputs, the state's static moments and its
pass generator, so the copies into the static inputs, the moments zeroed
at each pass's start and the generator seeded at each pass's start are
held against eager passes: FDS tables, BN buffers and the moments each
update receives. On the card (the ``cuda`` tests) captured CUDA graphs are
held bit for bit against eager passes: the fused BiLSTM with dropout, a
ResNet with augment and train-mode BN, and the depth encoder-decoder on
K3's split kernel, each over two passes with graphed steps between them.

This file imports neither jax nor the JAX package, so its ``cuda`` tests
also run on a machine with only PyTorch:

    python -m pytest --noconftest tests/test_torch_graphed_pass.py -q -m cuda
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_graphed_step import (
    _fake_record,
    bilstm_data,
    bilstm_trainer,
    resnet_data,
    resnet_trainer,
    take_nested,
)

from imbalanced_regression_tpu_torch import train
from imbalanced_regression_tpu_torch.fds import FDSConfig
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.parallel.mesh import create_mesh
from imbalanced_regression_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    restore_state,
    snapshot_state,
)
from imbalanced_regression_tpu_torch.utils.logging_tools import recorder, step_log

ROWS = 8
MOMENTS = ("count", "total", "total_sq", "has_lo", "has_hi")
TABLES = ("running_mean", "running_var", "running_mean_last_epoch", "running_var_last_epoch",
          "smoothed_mean_last_epoch", "smoothed_var_last_epoch", "num_samples_tracked")


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


@pytest.fixture
def fake_graphs(monkeypatch):
    """Steps and stats passes on the CPU take the graphed path, with
    :class:`FakeGraph` for the captured graph."""
    monkeypatch.setattr(train, "graphable", lambda device, mesh: mesh is None)
    monkeypatch.setattr(train.StepGraphs, "_record", _fake_record)


def eager(monkeypatch):
    monkeypatch.setattr(train, "graphable", lambda device, mesh: False)


@pytest.fixture
def applied(monkeypatch):
    """Copies of the moments each stats pass's update receives, in order,
    with whether any tensor of the updated FDS state shares storage with
    them."""
    seen = []
    update = train.fds_apply_moments

    def spy(config, state, moments, epoch):
        new = update(config, state, moments, epoch)
        storages = {getattr(moments, f).untyped_storage().data_ptr() for f in MOMENTS}
        seen.append({**{f: getattr(moments, f).clone() for f in MOMENTS},
                     "aliased": any(getattr(new, f).untyped_storage().data_ptr() in storages
                                    for f in TABLES)})
        return new

    monkeypatch.setattr(train, "fds_apply_moments", spy)
    return seen


# ---------------------------------------------------------------- runs
def depth_trainer(device):
    """The NYUD2 trainer at 64x96 (the encoder-decoder in bf16, the
    photometric augment, FDS on the per-pixel hook: 1,536 rows an image, so
    K3 takes its split kernel from 3 images a batch)."""
    from imbalanced_regression_tpu_torch.data.nyud2 import (
        make_pixel_weight_fn,
        nyud2_train_photometric,
    )
    from imbalanced_regression_tpu_torch.models.depth_encdec import (
        DepthEncoderDecoder,
        DepthHead,
        depth_feature_dim,
    )

    feat = depth_feature_dim(8 * 32)
    return Trainer(DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8, dtype=torch.bfloat16),
                   DepthHead(feat),
                   TrainerConfig(loss="mse", lr=1e-4, adam_weight_decay=1e-4, schedule=(5,)),
                   fds_config=FDSConfig.for_depth(feature_dim=feat),
                   train_augment=nyud2_train_photometric,
                   weight_fn=make_pixel_weight_fn(np.linspace(0.5, 2.0, 100)), device=device)


def family(name):
    """(trainer maker, data, indexed, rows a batch)."""
    if name == "bilstm":
        return bilstm_trainer, bilstm_data(), True, ROWS
    if name == "resnet":
        return resnet_trainer, resnet_data(), False, ROWS
    from imbalanced_regression_tpu_torch.data.nyud2 import synthetic_depth_dataset

    return depth_trainer, synthetic_depth_dataset(48, seed=6), False, 4


class Run:
    """A trainer's state, with stats passes and steps over batches of
    ``data``'s rows in one shuffled order (each batch used once)."""

    def __init__(self, trainer, data, indexed, rows=ROWS, seed=0):
        self.trainer, self.data, self.indexed, self.rows = trainer, data, indexed, rows
        self.state = trainer.init_state(seed)
        self.order = np.random.default_rng(7).permutation(len(data["target"]))
        self.next = 0
        if indexed:
            trainer.bind_device_data(data)

    def rows_of(self, sizes):
        out = []
        for n in sizes:
            out.append(self.order[self.next:self.next + n])
            self.next += n
        return out

    def take(self, idx):
        return {k: take_nested(v, idx) for k, v in self.data.items()}

    def stats_pass(self, epoch, batches=2, sizes=None):
        rows = self.rows_of(sizes or [self.rows] * batches)
        if self.indexed:
            self.state = self.trainer.fds_epoch_pass_indexed(self.state, iter(rows), epoch)
        else:
            self.state = self.trainer.fds_epoch_pass(self.state, iter(map(self.take, rows)), epoch)

    def steps(self, epoch, k=3):
        for idx in self.rows_of([self.rows] * k):
            if self.indexed:
                self.state, _, _ = self.trainer.train_step_indexed(self.state, idx, epoch)
            else:
                self.state, _, _ = self.trainer.train_step(self.state, self.take(idx), epoch)


def set_up_and_window(run):
    """Set-up-sized passes (two batches) at epochs 0 and 1, three steps at
    epoch 2, a window-sized pass (five batches) at epoch 2."""
    run.stats_pass(0)
    run.stats_pass(1)
    run.steps(2)
    run.stats_pass(2, batches=5)


def kinds(trainer):
    """Each ``pass_batch`` span's kind: ``eager``, ``capture`` (captured,
    then replayed) or ``replay``."""
    spans = recorder.closed("pass_batch", "pass_capture", "pass_replay",
                            trainer=trainer.trace_id)
    inner = {}
    for s in spans:
        if s.name != "pass_batch":
            inner.setdefault(id(s.parent), s.name[len("pass_"):])  # a capture closes first
    return [inner.get(id(s), "eager") for s in spans if s.name == "pass_batch"]


def assert_passes_equal(got, want, got_applied, want_applied):
    for part in ("backbone", "head"):
        g, w = getattr(got, part).state_dict(), getattr(want, part).state_dict()
        for k in w:  # the parameters, and the BN buffers the passes update
            assert torch.equal(g[k], w[k]), f"{part}.{k}"
    for f in TABLES:
        assert torch.equal(getattr(got.fds, f), getattr(want.fds, f)), f
    assert got.fds.epoch == want.fds.epoch
    assert len(got_applied) == len(want_applied)
    for g, w in zip(got_applied, want_applied):
        for f in MOMENTS:
            assert torch.equal(g[f], w[f]), f
        assert not g["aliased"]


# ------------------------------------------------------------ CPU tests
@pytest.mark.parametrize("where", ["cpu", "mesh", "anomaly"])
def test_pass_runs_eagerly_on_the_cpu_under_a_mesh_and_in_anomaly_mode(where, monkeypatch):
    """The pass asks ``graphable``: on the CPU it is false; with it made
    true for every device without a mesh (the stand-in graphs), a one-rank
    mesh and anomaly mode still run every batch eagerly, each a
    ``pass_batch`` span with no capture or replay inside, and no pass graph
    is warmed, captured or replayed."""
    real = train.graphable
    if where != "cpu":  # the card's answer, on the CPU
        monkeypatch.setattr(train, "graphable", lambda device, mesh: real(torch.device("cuda"),
                                                                           mesh))
        monkeypatch.setattr(train.StepGraphs, "_record", _fake_record)
    mesh = create_mesh(1, device="cpu") if where == "mesh" else None
    try:
        parts = resnet_trainer("cpu")
        trainer = Trainer(parts.backbone, parts.head, parts.config, fds_config=parts.fds_config,
                          train_augment=parts.train_augment, device="cpu", mesh=mesh)
        run = Run(trainer, resnet_data(), indexed=False)
        with torch.autograd.set_detect_anomaly(where == "anomaly"):
            run.stats_pass(0)
            run.stats_pass(1, batches=3)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    assert trainer.graph_stats["pass"] == {"captures": 0, "replays": 0, "eager": 5}
    assert kinds(trainer) == ["eager"] * 5
    assert run.state.graphs.entries == {} and run.state.graphs.warmed == set()
    assert [s.rows for s in recorder.closed("pass_batch", trainer=trainer.trace_id)] == [ROWS] * 5


def test_pass_graphs_engage_where_the_step_is_graphed(monkeypatch):
    """The same passes with ``graphable`` giving the card's answer without
    a mesh or anomaly mode: the second batch captures, the rest replay."""
    real = train.graphable
    monkeypatch.setattr(train, "graphable", lambda device, mesh: real(torch.device("cuda"), mesh))
    monkeypatch.setattr(train.StepGraphs, "_record", _fake_record)
    trainer = resnet_trainer("cpu")
    run = Run(trainer, resnet_data(), indexed=False)
    run.stats_pass(0)
    run.stats_pass(1, batches=3)
    assert kinds(trainer) == ["eager", "capture", "replay", "replay", "replay"]
    assert trainer.graph_stats["pass"] == {"captures": 1, "replays": 4, "eager": 1}


@pytest.mark.parametrize("name", ["resnet", "bilstm"])
def test_graphed_passes_equal_eager_passes(name, fake_graphs, monkeypatch, applied):
    """Set-up-sized and window-sized passes, steps between them, with
    stand-in graphs against eager passes: the streaming path (a ResNet with
    augment and train-mode BN) and the indexed path (the BiLSTM with
    dropout). The graphed passes add into the state's static moments,
    which the updates receive and the new FDS states do not alias."""
    make, data, indexed, rows = family(name)
    graphed = make("cpu")
    got = Run(graphed, data, indexed, rows)
    set_up_and_window(got)
    assert kinds(graphed) == ["eager", "capture"] + ["replay"] * 7
    assert graphed.graph_stats["pass"] == {"captures": 1, "replays": 8, "eager": 1}
    got_applied = list(applied)
    applied.clear()
    eager(monkeypatch)
    plain = make("cpu")
    want = Run(plain, data, indexed, rows)
    set_up_and_window(want)
    assert plain.graph_stats["pass"] == {"captures": 0, "replays": 0, "eager": 9}
    assert plain.graph_stats["step"]["replays"] == 0
    assert_passes_equal(got.state, want.state, got_applied, list(applied))
    assert torch.equal(got.state.generator.get_state(), want.state.generator.get_state())


@pytest.mark.parametrize("name", ["resnet", "bilstm"])
def test_key_is_pass_and_the_shapes_the_batch_work_reads(name, fake_graphs):
    """A new batch shape's first batch runs eagerly and its second
    captures; the key leaves out the loss weights, which the pass does not
    read; step and pass keys share the entries."""
    make, data, indexed, _ = family(name)
    trainer = make("cpu")
    run = Run(trainer, data, indexed)
    run.stats_pass(0, sizes=[ROWS, ROWS, 6, ROWS, 6, 6])
    assert kinds(trainer) == ["eager", "capture", "eager", "replay", "capture", "replay"]
    keys = set(run.state.graphs.entries)
    assert {key[0] for key in keys} == {"pass"}
    names = {tuple(k for k, _ in key[1]) for key in keys}
    assert names == {("input", "target", "bucket_idx") if indexed else ("input", "target")}
    assert {dict(key[1])["target"][0] for key in keys} == {(ROWS, 1), (6, 1)}
    run.steps(1, k=2)
    assert len(run.state.graphs.entries) == 3


def test_spans_and_counts_of_the_graphed_pass(fake_graphs):
    """``pass_batch`` spans (with their rows) inside the ``fds_pass`` span,
    each capture and replay inside its batch; the pass opens no ``capture``
    or ``replay`` span, so the steps' replay count (``graphed_step_pct``'s)
    is the graphed steps' alone; ``Trainer.epoch_log`` reports the pass
    counts, ``step_log`` of the spans alone none."""
    trainer = resnet_trainer("cpu")
    run = Run(trainer, resnet_data(), indexed=False)
    set_up_and_window(run)
    spans = recorder.closed(trainer=trainer.trace_id)
    passes = [s for s in spans if s.name == "fds_pass"]
    batches = [s for s in spans if s.name == "pass_batch"]
    assert len(passes) == 3 and len(batches) == 9
    assert all(s.parent in passes and s.rows == ROWS for s in batches)
    assert [s.parent.epoch for s in batches] == [0, 0, 1, 1, 2, 2, 2, 2, 2]
    capture, = [s for s in spans if s.name == "pass_capture"]
    replays = [s for s in spans if s.name == "pass_replay"]
    assert capture.parent is batches[1] and [s.parent for s in replays] == batches[1:]
    assert all(s.start_ns >= s.parent.start_ns and s.end_ns <= s.parent.end_ns
               for s in replays + [capture])
    step_replays = [s for s in spans if s.name == "replay"]
    assert len(step_replays) == trainer.graph_stats["step"]["replays"] == 2
    assert all(s.parent.name == "step" for s in step_replays)
    assert not [s for s in spans if s.name == "capture" and s.parent.name != "step"]
    log = trainer.epoch_log()
    assert (log["pass_graph_replays"], log["pass_eager_batches"]) == (8, 1)
    assert "pass_graph_replays" not in step_log(spans)


def test_pass_graphs_dropped_with_the_step_graphs(fake_graphs):
    """``restore_state``, the optimizer's ``load_state_dict`` and a new
    ``init_state`` drop the pass graphs, the static moments and the pass
    generator with the step graphs; the next pass warms up and captures
    again."""
    trainer = resnet_trainer("cpu")
    run = Run(trainer, resnet_data(n=160), indexed=False)
    graphs = run.state.graphs

    def assert_dropped():
        assert graphs.entries == {} and graphs.warmed == set()
        assert graphs.moments is None and graphs.pass_generator is None

    run.stats_pass(0)
    assert {key[0] for key in graphs.entries} == {"pass"} and graphs.moments is not None
    restore_state(run.state, snapshot_state(run.state))
    assert_dropped()
    run.stats_pass(1)
    run.state.optimizer.load_state_dict(run.state.optimizer.state_dict())
    assert_dropped()
    run.stats_pass(2)
    run.state = trainer.init_state(1)
    assert_dropped()
    assert run.state.graphs is not graphs
    run.stats_pass(3)
    assert kinds(trainer) == ["eager", "capture"] * 4


# ----------------------------------------------------------- card tests
def _counts():
    return [fn.launches for fn in ck.KERNEL_WRAPPERS], dict(ck.segment_moments.kernels)


def _two_passes(make, data, indexed, rows):
    """A pass of three batches at epoch 0, three steps at epoch 1 (eager,
    capture, replay; smoothing on), a pass of three batches at epoch 1."""
    run = Run(make, data, indexed, rows)
    run.stats_pass(0, batches=3)
    run.steps(1)
    run.stats_pass(1, batches=3)
    torch.cuda.synchronize()
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bilstm", "resnet", "depth"])
def test_graphed_passes_bit_equal_to_eager_on_card(cuda_device, deterministic, monkeypatch,
                                                   applied, name):
    """Two passes with graphed steps between them, captured and replayed,
    against eager passes and steps from the same seeds: the moments each
    update receives, the FDS state, BN buffers, parameters and the
    generator bit for bit; the graphs' K3 launches (by kernel) counted as
    the eager calls count theirs. The depth passes run K3's split kernel."""
    make, data, indexed, rows = family(name)
    ck.reset_launch_counts()
    graphed = make(cuda_device)
    got = _two_passes(graphed, data, indexed, rows)
    got_counts, got_applied = _counts(), list(applied)
    assert graphed.graph_stats["pass"] == {"captures": 1, "replays": 5, "eager": 1}
    assert graphed.graph_stats["step"] == {"captures": 1, "replays": 2, "eager": 1}
    assert kinds(graphed) == ["eager", "capture"] + ["replay"] * 4
    eager(monkeypatch)
    applied.clear()
    ck.reset_launch_counts()
    plain = make(cuda_device)
    want = _two_passes(plain, data, indexed, rows)
    assert got_counts == _counts()
    assert got_counts[0][2] == 6  # K3, once a pass batch
    if name == "depth":
        assert got_counts[1] == {"split": 6}
    assert_passes_equal(got.state, want.state, got_applied, list(applied))
    assert torch.equal(got.state.generator.get_state(), want.state.generator.get_state())
