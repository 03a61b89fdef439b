"""The port's serving path (``imbalanced_regression_tpu_torch/serving.py``,
``tools/export_model.py``, ``tools/serve_bench.py``) held against the JAX
package's ``serving.py`` on the CPU.

Each model is trained one step by the JAX Trainer, as in
``tests/test_serving.py``, and its weights are carried into the port
(``convert.from_flax``, ``depth_from_flax``, ``stsb_from_flax``). The port's
exported predictor then agrees with the JAX package's exported predictor on
the same input: the age ResNet (float32, uint8 input) within 1e-5, the
NYUD2 encoder-decoder (float32, width 8, 64x96) within 1e-3 as the JAX test
allows, the STS-B pair encoder (float32, dict input) within 1e-5 of the
largest magnitude. Against the port's own ``Trainer.predict_batch`` it is
exact: both run the same aten ops on the same thread count.

Also: other batch sizes, devices the artifact lacks and JAX artifacts are
refused; an artifact serves in a fresh process that imports only
``serving`` after the live weights were zeroed; ``embed_weights`` changes
nothing; the export CLI round-trips a port checkpoint; ``serve_bench`` gives
sane rows on the CPU; the entry points default to ``cuda``."""

import json
import subprocess
import sys
import types
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_stsb_tiny import pair_input

from imbalanced_regression_tpu.data import augment as jaugment
from imbalanced_regression_tpu.data import nyud2 as jnyud2
from imbalanced_regression_tpu.fds import FDSConfig as JFDSConfig
from imbalanced_regression_tpu.models.bilstm_pair import PairBiLSTMEncoder as JEncoder
from imbalanced_regression_tpu.models.depth_encdec import DepthEncoderDecoder as JDepth
from imbalanced_regression_tpu.models.depth_encdec import DepthHead as JDepthHead
from imbalanced_regression_tpu.models.resnet import RegressionHead as JHead
from imbalanced_regression_tpu.models.resnet import ResNetBasicBackbone as JBasic
from imbalanced_regression_tpu.ops.lds import prepare_weights_depth
from imbalanced_regression_tpu.parallel.mesh import create_mesh
from imbalanced_regression_tpu.serving import export_predictor as jax_export
from imbalanced_regression_tpu.serving import load_predictor as jax_load
from imbalanced_regression_tpu.train import Trainer as JTrainer
from imbalanced_regression_tpu.train import TrainerConfig as JTrainerConfig
from imbalanced_regression_tpu_torch import serving
from imbalanced_regression_tpu_torch.convert import depth_from_flax, from_flax, stsb_from_flax
from imbalanced_regression_tpu_torch.data.augment import normalize_only
from imbalanced_regression_tpu_torch.data.nyud2 import imagenet_normalize
from imbalanced_regression_tpu_torch.models.bilstm_pair import PairBiLSTMEncoder
from imbalanced_regression_tpu_torch.models.depth_encdec import (
    DepthEncoderDecoder,
    DepthHead,
    depth_feature_dim,
)
from imbalanced_regression_tpu_torch.models.resnet import RegressionHead, ResNetBasicBackbone
from imbalanced_regression_tpu_torch.serving import (
    export_predictor,
    load_predictor,
    load_predictor_file,
    save_predictor,
)
from imbalanced_regression_tpu_torch.train import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parents[1]
MODELS = ["age", "nyud2", "stsb"]  # the builders below
STS_VOCAB = 50


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _age():
    """The JAX test's age model: ResNetBasicBackbone (1 stage, width 8,
    float32) with ``normalize_only``, one L1 step; served on uint8."""
    jtrainer = JTrainer(
        JBasic(stage_sizes=(1,), width=8, dtype=jnp.float32), JHead(),
        JTrainerConfig(loss="l1", lr=1e-2),
        fds_config=JFDSConfig.for_age(feature_dim=8, bucket_num=121, start_smooth=0),
        mesh=create_mesh(1), eval_transform=jaugment.normalize_only)
    rng = np.random.default_rng(0)
    x = (rng.random((8, 24, 24, 3)) * 255).astype(np.uint8)
    batch = {"input": x.astype(np.float32), "target": rng.normal(40, 20, (8, 1)).astype(np.float32)}
    jstate = jtrainer.init_state(jax.random.key(0), batch["input"][:2])
    jstate, _, _ = jtrainer.train_step(jstate, batch, epoch=1)
    sd = from_flax(_np({"params": jstate.params["backbone"], "batch_stats": jstate.batch_stats}),
                   _np(jstate.params["head"]))
    make = lambda: Trainer(  # noqa: E731
        ResNetBasicBackbone(stage_sizes=(1,), width=8, dtype=torch.float32), RegressionHead(8),
        TrainerConfig(), eval_transform=normalize_only, device="cpu")
    return jtrainer, jstate, make, sd, x, lambda want: {"rtol": 1e-5, "atol": 1e-5}


def _nyud2():
    """The JAX test's dense model: DepthEncoderDecoder (stages 1,1,1,1,
    width 8, float32) with ``imagenet_normalize``, one MSE step on 64x96."""
    feat = depth_feature_dim(8 * 32)
    jtrainer = JTrainer(
        JDepth(stage_sizes=(1, 1, 1, 1), width=8, dtype=jnp.float32), JDepthHead(),
        JTrainerConfig(loss="mse", lr=1e-4, adam_weight_decay=1e-4, schedule=()),
        fds_config=JFDSConfig.for_depth(feature_dim=feat, bucket_num=100, bucket_start=7,
                                        start_update=0, start_smooth=0),
        mesh=create_mesh(1), train_augment=jnyud2.nyud2_train_photometric,
        eval_transform=jnyud2.imagenet_normalize,
        weight_fn=jnyud2.make_pixel_weight_fn(prepare_weights_depth(
            jnyud2.TRAIN_BUCKET_NUM, "sqrt_inv", bucket_num=100, bucket_start=7, lds=True)))
    rng = np.random.default_rng(0)
    batch = {"input": rng.random((4, 64, 96, 3)).astype(np.float32),
             "target": (rng.random((4, 32, 48, 1)) * 10).astype(np.float32)}
    jstate = jtrainer.init_state(jax.random.key(0), batch["input"][:2])
    jstate, _, _ = jtrainer.train_step(jstate, batch, epoch=1)
    sd = depth_from_flax(_np({"params": jstate.params["backbone"],
                              "batch_stats": jstate.batch_stats}), _np(jstate.params["head"]))
    make = lambda: Trainer(  # noqa: E731
        DepthEncoderDecoder(stage_sizes=(1, 1, 1, 1), width=8, dtype=torch.float32),
        DepthHead(feat), TrainerConfig(loss="mse"), eval_transform=imagenet_normalize, device="cpu")
    # separately compiled float32 conv stacks reorder reductions (the JAX test's 1e-3)
    return jtrainer, jstate, make, sd, batch["input"], lambda want: {"rtol": 1e-3, "atol": 1e-3}


def _stsb(lstm_impl="fused"):
    """A float32 pair encoder (one BiLSTM layer, d_hid 16, in the
    ``lstm_impl`` layout) and head, one MSE step on targets / 5; served on
    a dict with columns of 9 and 7 tokens."""
    jtrainer = JTrainer(
        JEncoder(vocab_size=STS_VOCAB, d_word=8, d_hid=16, n_layers=1, dropout=0.0,
                 dropout_embs=0.0, train_words=True, lstm_impl=lstm_impl), JHead(),
        JTrainerConfig(loss="mse", lr=1e-2, target_scale=5.0, schedule=()), mesh=create_mesh(1))
    rng = np.random.default_rng(0)
    inp = pair_input(rng, 4, 9, 7, STS_VOCAB)
    batch = {"input": inp, "target": rng.uniform(0, 5, (4, 1)).astype(np.float32)}
    jstate = jtrainer.init_state(jax.random.key(0), jax.tree.map(lambda v: v[:2], inp))
    jstate, _, _ = jtrainer.train_step(jstate, batch, epoch=0)
    sd = stsb_from_flax(_np({"params": jstate.params["backbone"]}), _np(jstate.params["head"]))
    make = lambda: Trainer(  # noqa: E731
        PairBiLSTMEncoder(STS_VOCAB, d_word=8, d_hid=16, n_layers=1, dropout=0.0,
                          dropout_embs=0.0, train_words=True, lstm_impl=lstm_impl),
        RegressionHead(8 * 16), TrainerConfig(loss="mse"), device="cpu")
    # the float32 encoder's tolerance in tests/test_torch_stsb_model.py
    return jtrainer, jstate, make, sd, inp, lambda want: {
        "rtol": 1e-5, "atol": 1e-5 * float(np.abs(want).max())}


# the per-direction BiLSTM layout (lstm_impl="flax") freezes as the fused one does
BUILDERS = {"age": _age, "nyud2": _nyud2, "stsb": _stsb, "stsb_flax": partial(_stsb, "flax")}


@pytest.fixture(scope="module")
def built():
    """``built(name)``: the model's JAX trainer and state after one step,
    its JAX predictor's output, and ``port()``, which makes the port's
    trainer and state on the converted weights; made once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            jtrainer, jstate, make, sd, x, tol = BUILDERS[name]()
            jax_blob = jax_export(jtrainer, jstate, x, platforms=("cpu",))

            def port():
                trainer = make()
                state = trainer.init_state(0)
                state.backbone.load_state_dict(sd["backbone"])
                state.head.load_state_dict(sd["head"])
                return trainer, state

            cache[name] = types.SimpleNamespace(
                jtrainer=jtrainer, jstate=jstate, x=x, tol=tol, jax_blob=jax_blob,
                jax_out=np.asarray(jax_load(jax_blob)(x)), port=port)
        return cache[name]

    return get


def _target(x) -> np.ndarray:
    n = len(next(iter(x.values()))) if isinstance(x, dict) else len(x)
    return np.zeros((n, 1), np.float32)


def _rows(x, n):
    return {k: v[:n] for k, v in x.items()} if isinstance(x, dict) else x[:n]


@pytest.mark.parametrize("name", MODELS + ["stsb_flax"])
def test_predictor_matches_jax_and_predict_batch(built, name):
    m = built(name)
    trainer, state = m.port()
    blob = export_predictor(trainer, state, m.x, platforms=("cpu",))
    # the signature is kept, the sample itself is not shipped
    sts = name.startswith("stsb")
    assert not any(leaf.tobytes() in blob for leaf in (m.x.values() if sts else [m.x]))
    predict = load_predictor(blob)
    got = predict(m.x)
    assert got.shape == m.jax_out.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, m.jax_out, **m.tol(m.jax_out))
    want = trainer.predict_batch(state, {"input": m.x, "target": _target(m.x)})
    np.testing.assert_array_equal(got, want)
    assert predict.platforms == ("cpu",) and predict.device == torch.device("cpu")
    if sts:
        assert predict.in_shape is None
        assert [a.shape for a in predict.data_avals] == [(4, 9), (4, 7), (4, 9), (4, 7)]
    else:
        assert predict.in_shape == m.x.shape
        assert predict.data_avals == (serving.Aval(m.x.shape, m.x.dtype),)


@pytest.mark.parametrize("name", MODELS)
def test_other_signatures_are_refused(built, name):
    """Another batch size, another dtype, and a dict for an array (or an
    array for a dict) are refused before the program runs; the graph's own
    shape guard refuses another batch size too."""
    m = built(name)
    trainer, state = m.port()
    predict = load_predictor(export_predictor(trainer, state, m.x, platforms=("cpu",)))
    three = _rows(m.x, 3)
    with pytest.raises(ValueError, match="exported for"):
        predict(three)
    with pytest.raises(Exception, match="Guard failed|Expected input"):  # torch's wording
        predict.run({k: torch.as_tensor(v) for k, v in three.items()}
                    if isinstance(three, dict) else torch.as_tensor(three))
    if isinstance(m.x, dict):
        other_dtype = {**m.x, "mask1": m.x["mask1"].astype(np.float64)}
        with pytest.raises(ValueError, match="takes a dict of"):
            predict(m.x["tokens1"])
    else:
        other_dtype = m.x.astype(np.float64)
        with pytest.raises(ValueError, match="takes one array"):
            predict({"x": m.x})
    with pytest.raises(ValueError, match="exported for"):
        predict(other_dtype)


SUBPROCESS = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
from imbalanced_regression_tpu_torch.serving import load_predictor_file
out = {}
for name, path in json.loads(sys.argv[1]).items():
    data = np.load(path + ".npz")
    x = {k: data[k] for k in data.files} if len(data.files) > 1 else data[data.files[0]]
    out[name] = load_predictor_file(path)(x).tolist()
mods = sorted(m for m in sys.modules if m.startswith("imbalanced_regression_tpu"))
print(json.dumps({"out": out, "modules": mods}))
"""


def test_artifact_is_self_contained(built, tmp_path):
    """Export each model, zero the live weights, then serve the artifacts
    in a fresh process that imports only ``serving``: the predictions
    before the zeroing come back bit for bit."""
    paths, want = {}, {}
    for name in MODELS:
        m = built(name)
        trainer, state = m.port()
        want[name] = trainer.predict_batch(state, {"input": m.x, "target": _target(m.x)})
        path = str(tmp_path / f"{name}.pt2")
        save_predictor(path, export_predictor(trainer, state, m.x, platforms=("cpu",)))
        np.savez(path + ".npz", **(m.x if isinstance(m.x, dict) else {"x": m.x}))
        with torch.no_grad():
            for t in [*state.backbone.parameters(), *state.head.parameters()]:
                t.zero_()
        zeroed = trainer.predict_batch(state, {"input": m.x, "target": _target(m.x)})
        assert not np.array_equal(zeroed, want[name])
        paths[name] = path
    proc = subprocess.run([sys.executable, "-c", SUBPROCESS, json.dumps(paths)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["modules"] == ["imbalanced_regression_tpu_torch",
                                 "imbalanced_regression_tpu_torch.serving"]
    for name in MODELS:
        np.testing.assert_array_equal(np.asarray(result["out"][name], np.float32), want[name])


def test_embed_weights_false_and_true_agree(built):
    m = built("age")
    trainer, state = m.port()
    embedded = load_predictor(export_predictor(trainer, state, m.x, platforms=("cpu",)))
    packed = load_predictor(export_predictor(trainer, state, m.x, platforms=("cpu",),
                                             embed_weights=False))
    np.testing.assert_array_equal(packed(m.x), embedded(m.x))
    assert packed.in_shape == embedded.in_shape == m.x.shape
    assert packed.platforms == embedded.platforms == ("cpu",)


def _relabel(blob: bytes, platforms: list) -> bytes:
    """``blob`` with its header's platform names replaced (the programs and
    their sizes unchanged): stands for an artifact exported elsewhere."""
    header, off = serving._parse(blob)
    header["platforms"] = platforms
    header["sizes"] = header["sizes"] * len(platforms)
    body = blob[off:] * len(platforms)
    raw = json.dumps(header).encode()
    return serving._MAGIC + len(raw).to_bytes(8, "little") + raw + body


def test_device_the_artifact_lacks_is_refused(built):
    m = built("age")
    trainer, state = m.port()
    blob = export_predictor(trainer, state, m.x, platforms=("cpu",))
    with pytest.raises(ValueError, match=r"no cuda program; it was exported for \['cpu'\]"):
        load_predictor(blob, "cuda")
    assert load_predictor(blob).device == torch.device("cpu")  # its one platform
    with pytest.raises(ValueError, match="unknown platform 'tpu'"):
        export_predictor(trainer, state, m.x, platforms=("tpu",))
    # an artifact with a cuda and a cpu program: the cpu one loads on request
    both = _relabel(blob, ["cuda", "cpu"])
    predict = load_predictor(both, "cpu")
    assert predict.platforms == ("cuda", "cpu")
    np.testing.assert_array_equal(predict(m.x), load_predictor(blob)(m.x))


@pytest.mark.parametrize("packed", [False, True], ids=["embedded", "weights_as_args"])
def test_jax_artifact_is_refused(built, packed):
    m = built("age")
    blob = m.jax_blob if not packed else jax_export(m.jtrainer, m.jstate, m.x, platforms=("cpu",),
                                                    embed_weights=False)
    with pytest.raises(ValueError, match="JAX"):
        load_predictor(blob)


@pytest.mark.parametrize("task", ["age", "nyud2"])
def test_export_cli_roundtrip(task, tmp_path, monkeypatch, capsys):
    """``tools/export_model.py`` over a port checkpoint (tiny models patched
    in): the artifact serves the checkpoint's weights, not the fresh ones
    the CLI builds before restoring."""
    from imbalanced_regression_tpu_torch.tasks import age, nyud2
    from imbalanced_regression_tpu_torch.tools import export_model as em
    from imbalanced_regression_tpu_torch.utils.checkpoint import save_checkpoint

    if task == "age":
        monkeypatch.setitem(age.BACKBONES, "resnet50", (
            lambda dtype, remat: ResNetBasicBackbone(stage_sizes=(1,), width=8, dtype=dtype), 8))
        flags, shape = ["--img_size", "24"], (4, 24, 24, 3)
        x = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    else:
        monkeypatch.setattr(nyud2, "NYUDConfig", partial(nyud2.NYUDConfig, stage_sizes=(1, 1, 1, 1),
                                                         width=8))
        monkeypatch.setattr(em, "NYUD2_HW", (64, 96))
        flags, shape = [], (4, 64, 96, 3)
        x = np.random.default_rng(1).random(shape, dtype=np.float32)
    overrides = {"img_size": 24} if task == "age" else {}
    trainer, _ = em.build_task(task, overrides, "cpu")
    state = trainer.init_state(1)  # not the seed-0 weights build_task starts from
    ckpt = str(tmp_path / "store")
    save_checkpoint(ckpt, state, epoch=1, best_loss=1.0, is_best=True)

    out = str(tmp_path / "m.pt2")
    em.main([ckpt, out, "--task", task, "--batch", "4", *flags, "--platforms", "cpu",
             "--device", "cpu"])
    em.main(["--load", out, "--batch", "4", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"exported {task} (epoch 1, best 1.0)" in printed
    assert f"platforms=('cpu',) device=cpu in={shape}" in printed
    predict = load_predictor_file(out)
    assert predict.in_shape == shape
    assert predict.data_avals[0].dtype == (np.uint8 if task == "age" else np.float32)
    np.testing.assert_array_equal(predict(x), trainer.predict_batch(
        state, {"input": x, "target": _target(x)}))


def test_serve_bench_cli_smoke():
    """``tools/serve_bench.py`` over the resnet18 registry entry on the CPU:
    sane JSON rows, with no device time or card named."""
    from imbalanced_regression_tpu_torch.tools import serve_bench as sb

    results = sb.main(["--task", "age", "--model", "resnet18", "--img_size", "24",
                       "--batches", "1", "4", "--iters", "3", "--device", "cpu"])
    assert [r["batch"] for r in results] == [1, 4]
    for r in results:
        assert r["ms_per_batch"] > 0 and r["img_per_sec"] > 0
        assert r["p50_ms"] <= r["p99_ms"] * 1.0001
        assert r["platform"] == "cpu" and r["input_dtype"] == "uint8"
        assert r["device_ms"] is None and r["device_name"] is None and r["power_limit"] is None


def test_entry_points_default_to_cuda(built, monkeypatch, tmp_path):
    """Without a GPU, export, load and both CLIs refuse to run unless asked
    for the CPU."""
    from imbalanced_regression_tpu_torch.tools import export_model as em
    from imbalanced_regression_tpu_torch.tools import serve_bench as sb

    m = built("age")
    trainer, state = m.port()
    blob = export_predictor(trainer, state, m.x, platforms=("cpu",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_predictor(trainer, state, m.x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor(_relabel(blob, ["cuda", "cpu"]))  # cuda where the artifact has it
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sb.main(["--model", "resnet18", "--img_size", "24", "--batches", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        em.main([str(tmp_path), str(tmp_path / "m.pt2"), "--img_size", "24"])
