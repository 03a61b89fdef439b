"""The port's experiment and data tools (``imbalanced_regression_tpu_torch/
tools/``) held against the JAX package's (``tools/``) on the CPU: the sweep's
``grid()`` (the same store names in the same order, equal fields), its RRT
pairing, resume and mode-mismatch rerun (``tests/test_tools.py``'s tests,
with ``tasks.age.run`` stubbed), a real tiny sweep whose JSONL both
aggregators read alike; ``aggregate``, ``paired_deltas`` and ``usable``;
``sts_seeds``' arms, budget key, skip and summary; the dataset tools'
outputs on the same fixtures and seeds, compared as parsed rows; the bench
at a tiny size; and that no module of the port imports jax, flax, pandas,
the JAX package or the root ``tools`` package."""

import argparse
import csv
import dataclasses
import json
import os
import pkgutil
import subprocess
import sys
from datetime import date
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import torch
from PIL import Image

import imbalanced_regression_tpu_torch
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
from imbalanced_regression_tpu_torch.tools import aggregate_results as agg
from imbalanced_regression_tpu_torch.tools import bench, corpus_embeddings, create_age_meta
from imbalanced_regression_tpu_torch.tools import make_balanced_splits, make_synth_corpus
from imbalanced_regression_tpu_torch.tools import preprocess_nyud2, sts_seeds, sweep
from tools import aggregate_results as jagg
from tools import corpus_embeddings as jcorpus_embeddings
from tools import create_age_meta as jcreate_age_meta
from tools import make_balanced_splits as jmake_balanced_splits
from tools import make_synth_corpus as jmake_synth_corpus
from tools import preprocess_nyud2 as jpreprocess_nyud2
from tools import sts_seeds as jsts_seeds
from tools import sweep as jsweep

REPO = Path(__file__).resolve().parents[1]
PORT_ONLY = {"device", "dist_backend"}  # config fields the JAX package has not


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


# ---------------------------------------------------------------- the sweep

GRID_ARGS = [
    [],
    ["--dataset", "agedb", "--losses", "l1", "mse", "--reweights", "sqrt_inv", "none",
     "--seeds", "2", "0", "--rrt"],
    ["--dataset", "agedb", "--lds_ks", "7", "--fds_sigma", "3.0", "--lds_options", "1", "0",
     "--fds_options", "1", "--rrt", "--rrt_from", "self", "--epoch", "2", "--batch_size", "64"],
    ["--reweights", "inverse", "--lds_options", "1", "--synthetic_size", "96", "--img_size",
     "32", "--lr", "1e-2", "--lds_sigma", "2.0", "--fds_ks", "9", "--store_root", "elsewhere"],
]


@pytest.mark.parametrize("argv", GRID_ARGS, ids=["defaults", "agedb_rrt", "agedb_overrides",
                                                 "inverse_lds"])
def test_grid_matches_jax(argv):
    args = sweep.parse_args(argv)
    ours, theirs = sweep.grid(args), jsweep.grid(argparse.Namespace(**vars(args)))
    assert [c.derived_store_name() for c in ours] == [c.derived_store_name() for c in theirs]
    assert len(ours) > 1
    for a, b in zip(ours, theirs):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert {k: v for k, v in a.items() if k not in PORT_ONLY} == b
        assert a["device"] == "cuda"
    assert all(c.device == "cpu" for c in sweep.grid(sweep.parse_args(argv + ["--device", "cpu"])))


def _fake_run(calls):
    def run(config):
        calls.append(config)
        store = os.path.join(config.store_root, config.derived_store_name())
        os.makedirs(store, exist_ok=True)
        Path(store, "best.pt").touch()
        return {"test": {"l1": 1.0, "mse": 1.0},
                "shots": {"many": {"l1": 1.0}, "median": {"l1": 1.0}, "low": {"l1": 1.0}}}
    return run


SWEEP_BASE = ["--losses", "l1", "--reweights", "none", "sqrt_inv", "--lds_options", "0",
              "--fds_options", "0", "--rrt", "--synthetic_size", "16", "--img_size", "32",
              "--epoch", "1", "--device", "cpu"]


def test_sweep_rrt_vanilla_pairing_and_resume(tmp_path, monkeypatch):
    """RRT stage 2 loads the matching vanilla stage-1 checkpoint and resumes
    on its own: a restart after stage 1's record still runs stage 2."""
    calls = []
    monkeypatch.setattr(sweep.age, "run", _fake_run(calls))
    argv = ["--store_root", str(tmp_path), *SWEEP_BASE]
    sweep.main(argv)
    stage2 = [c for c in calls if c.retrain_fc]
    assert len(stage2) == 1 and len(calls) == 3  # vanilla + sqrt_inv + stage 2
    vanilla = next(c for c in calls if c.reweight == "none" and not c.retrain_fc)
    assert stage2[0].pretrained.endswith(vanilla.derived_store_name())
    assert stage2[0].reweight == "sqrt_inv" and stage2[0].device == "cpu"

    calls.clear()  # a full JSONL: a rerun does nothing
    sweep.main(argv)
    assert calls == []

    results = tmp_path / "sweep_results.jsonl"  # drop stage 2's record: it reruns alone
    records = [json.loads(line) for line in results.read_text().splitlines()]
    assert [sorted(r) for r in records] == [["config", "name", "seed", "shots", "test"]] * 2 + \
        [["config", "name", "rrt_from", "seed", "shots", "test"]]
    results.write_text("\n".join(json.dumps(r) for r in records if "rrt_from" not in r) + "\n")
    calls.clear()
    sweep.main(argv)
    assert [c.retrain_fc for c in calls] == [True]


def test_sweep_orders_vanilla_cells_first(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(sweep.age, "run", _fake_run(calls))
    argv = ["--store_root", str(tmp_path), *SWEEP_BASE]
    argv[argv.index("none"):argv.index("sqrt_inv") + 1] = ["sqrt_inv", "none"]
    sweep.main(argv)
    assert [c.reweight for c in calls] == ["none", "sqrt_inv", "sqrt_inv"]
    assert [c.retrain_fc for c in calls] == [False, False, True]


def test_sweep_rrt_from_mode_mismatch_reruns(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(sweep.age, "run", _fake_run(calls))
    base = ["--store_root", str(tmp_path), *SWEEP_BASE]
    sweep.main(base + ["--rrt_from", "self"])
    calls.clear()
    sweep.main(base + ["--rrt_from", "vanilla"])
    assert len(calls) == 1 and calls[0].retrain_fc
    assert "sqrt_inv" not in os.path.basename(calls[0].pretrained)


def test_sweep_refuses_a_missing_stage_one(tmp_path, monkeypatch):
    monkeypatch.setattr(sweep.age, "run", _fake_run([]))
    argv = ["--store_root", str(tmp_path), *SWEEP_BASE]
    argv[argv.index("none")] = "inverse"
    with pytest.raises(SystemExit, match="needs the stage-1 checkpoint"):
        sweep.main(argv)


def test_tiny_sweep_runs_and_both_aggregators_read_it(tmp_path, monkeypatch, capsys):
    """A real sweep on the CPU (ResNet-18 under the resnet50 name, 32x32
    synthetic images, one epoch): stage 1 without and with re-weighting,
    each without and with FDS, stage 2 on the vanilla store after each
    re-weighted cell; the JAX and the port's aggregators agree on its
    JSONL."""
    from imbalanced_regression_tpu_torch.tasks import age

    monkeypatch.setitem(age.BACKBONES, "resnet50", age.BACKBONES["resnet18"])
    path = sweep.main(["--store_root", str(tmp_path), "--losses", "l1", "--reweights", "none",
                       "sqrt_inv", "--lds_options", "0", "--fds_options", "0", "1", "--rrt",
                       "--synthetic_size", "48", "--img_size", "32", "--batch_size", "16",
                       "--epoch", "1", "--device", "cpu"])
    records = agg.load(path)
    assert [("rrt_from" in r, r["config"]["reweight"], r["config"]["fds"]) for r in records] == \
        [(False, "none", 0), (False, "none", 1), (False, "sqrt_inv", 0), (True, "sqrt_inv", 0),
         (False, "sqrt_inv", 1), (True, "sqrt_inv", 1)]
    vanilla = records[0]["name"]
    assert {r["rrt_from"] for r in records if "rrt_from" in r} == {vanilla}
    assert all(np.isfinite(r["test"]["l1"]) for r in records)
    assert agg.aggregate(records) == jagg.aggregate(jagg.load(path))
    capsys.readouterr()
    agg.main([path])
    ours = capsys.readouterr().out
    jagg.main([path])
    assert ours == capsys.readouterr().out and "config" in ours


# ----------------------------------------------------------- the aggregator

def _records():
    rng = np.random.default_rng(0)
    out = []
    for seed in (0, 1, 2):
        for name in ("imdb_wiki_resnet50_adam_l1_0.001_256", "imdb_wiki_resnet50_sqrt_inv_adam_l1"):
            full = f"{name}_seed{seed}" if seed else name
            v = lambda: float(rng.uniform(5, 10))  # noqa: E731
            out.append({"name": full, "seed": seed, "config": {"seed": seed},
                        "test": {"l1": v(), "mse": v(), "gmean": v()},
                        "shots": {r: {"l1": v(), "mse": v(), "gmean": v()}
                                  for r in ("many", "median", "low")}})
    out[1]["shots"]["low"]["gmean"] = 0.0  # degenerate
    out[2]["test"]["mse"] = float("nan")
    out.append({"name": "legacy", "test": {"l1": 3.0}})  # no seed, config or shots
    return out


@pytest.mark.parametrize("metric", ["l1", "mse", "gmean"])
def test_aggregate_and_paired_deltas_match_the_original(metric):
    records = _records()
    assert agg.aggregate(records, metric) == jagg.aggregate(records, metric)
    base = "imdb_wiki_resnet50_adam_l1_0.001_256"
    ours, theirs = agg.paired_deltas(records, base, metric), jagg.paired_deltas(records, base, metric)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    for name in ("x_seed3", "x_seed12", "x", "x_seed"):
        assert agg.strip_seed(name) == jagg.strip_seed(name)


@pytest.mark.parametrize("metric,v", [("gmean", 0.0), ("gmean", -1.0), ("gmean", 0.5),
                                      ("l1", 0.0), ("l1", None), ("mse", float("nan")),
                                      ("mse", float("inf"))])
def test_usable_matches_the_original(metric, v):
    assert agg.usable(metric, v) == jagg.usable(metric, v)


def test_aggregate_cli_matches_the_original(tmp_path, capsys):
    path = tmp_path / "r.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in _records()) + "\n")
    outs = []
    for mod, out in ((agg, "ours.json"), (jagg, "theirs.json")):
        mod.main([str(path), "--metric", "mse", "--json", str(tmp_path / out),
                  "--paired", "imdb_wiki_resnet50_adam_l1_0.001_256"])
        outs.append(capsys.readouterr())
    assert outs[0] == outs[1]
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()


# ---------------------------------------------------------------- STS seeds

def test_sts_seeds_arms_and_budget_match_the_original():
    assert sts_seeds.ARMS == jsts_seeds.ARMS
    assert sts_seeds.BUDGET_FIELDS == jsts_seeds.BUDGET_FIELDS
    cfg = {"val_interval": 3, "max_vals": 2, "batch_size": 4, "d_hid": 8, "glove": 1}
    for arm, seed in (("vanilla", 0), ("rrt", "2")):
        assert sts_seeds._budget_key(arm, seed, cfg) == jsts_seeds._budget_key(arm, seed, cfg)


def test_sts_seeds_skips_by_budget_and_pairs_rrt(tmp_path, monkeypatch, capsys):
    """The JAX tool's budget-key test on the port's tool, with the RRT arm
    on the vanilla run's best checkpoint; the summary prints as the JAX
    tool's does on the same JSONL."""
    calls = []

    def fake_run(config):
        calls.append(config)
        store = os.path.join(config.store_root, config.derived_store_name())
        os.makedirs(store, exist_ok=True)
        Path(store, "best.pt").touch()
        return {"test": {"overall": {"mse": 1.0 + len(calls)}, "few": {"mse": 2.0}}}

    monkeypatch.setattr(sts_seeds.stsb, "run", fake_run)
    base = ["--data_dir", "unused", "--seeds", "0", "1", "--arms", "vanilla", "rrt",
            "--store_root", str(tmp_path), "--d_hid", "8", "--n_layers_enc", "1",
            "--batch_size", "4", "--device", "cpu"]
    sts_seeds.main(base + ["--max_vals", "2", "--val_interval", "3"])
    assert [(c.seed, c.retrain_fc) for c in calls] == [(0, False), (0, True), (1, False), (1, True)]
    vanilla = calls[0]
    assert calls[1].pretrained == os.path.join(str(tmp_path), vanilla.derived_store_name())
    assert all(c.resume == os.path.join(str(tmp_path), c.derived_store_name()) for c in calls)
    assert all(c.device == "cpu" for c in calls)
    sts_seeds.main(base + ["--max_vals", "2", "--val_interval", "3"])  # same budget: skipped
    assert len(calls) == 4
    sts_seeds.main(base + ["--max_vals", "5", "--val_interval", "3"])  # another: reruns
    assert len(calls) == 8
    path = str(tmp_path / "sts_seed_results.jsonl")
    capsys.readouterr()
    sts_seeds.print_summary(path)
    ours = capsys.readouterr().out
    jsts_seeds.print_summary(path)
    assert ours == capsys.readouterr().out and "paired per-seed deltas" in ours


def test_sts_seeds_rrt_needs_the_vanilla_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="rrt arm needs the vanilla"):
        sts_seeds.main(["--data_dir", "unused", "--seeds", "0", "--arms", "rrt",
                        "--store_root", str(tmp_path), "--device", "cpu"])


# ------------------------------------------------------------ dataset tools

@pytest.mark.parametrize("born,photo", [(date(1980, 3, 1), 2000), (date(1980, 9, 1), 2000),
                                        (date(1999, 6, 30), 2010), (date(1999, 7, 1), 2010),
                                        (date(2001, 1, 1), 2000)])
def test_calc_age_matches_the_original(born, photo):
    ordinal = born.toordinal() + 366 + 0.25  # a Matlab serial date with a time of day
    assert create_age_meta.calc_age(photo, ordinal) == jcreate_age_meta.calc_age(photo, ordinal)


def _imdb_wiki_fixture(root, seed=0, n=40):
    rng = np.random.default_rng(seed)
    for db in ("imdb", "wiki"):
        paths = np.empty(n, dtype=object)
        paths[:] = [f"{i:02d}/nm{i}_{db}.jpg" for i in range(n)]
        second = rng.uniform(0, 3, n)
        second[rng.random(n) < 0.6] = np.nan
        second[:3] = 0.0
        fields = {"full_path": paths[None, :],
                  "dob": rng.uniform(690000, 730000, n)[None, :],
                  "photo_taken": rng.integers(1990, 2015, n)[None, :],
                  "face_score": rng.uniform(-1, 5, n)[None, :],
                  "second_face_score": second[None, :]}
        fields["dob"][0, :2] = [1.0, 800000.0]  # a year-1 birth and one after the photo
        os.makedirs(os.path.join(root, f"{db}_crop"), exist_ok=True)
        scipy.io.savemat(os.path.join(root, f"{db}_crop", f"{db}.mat"), {db: fields})


def test_create_age_meta_matches_the_original(tmp_path):
    for name in ("ours", "theirs"):
        root = tmp_path / name
        _imdb_wiki_fixture(str(root))
        (root / "AgeDB").mkdir()
        for f in ("0_AlbertEinstein_35_m.jpg", "12_Ada_Lovelace_20_f.jpg", "7_Marie_60_f.jpg",
                  "3_Grace_Hopper_1_f.png", "notes.txt"):
            (root / "AgeDB" / f).touch()
    ours = create_age_meta.create_imdb_wiki(str(tmp_path / "ours"), 1.0)
    theirs = jcreate_age_meta.create_imdb_wiki(str(tmp_path / "theirs"), 1.0)
    assert _rows(ours) == _rows(theirs) and len(_rows(ours)) > 10
    assert _rows(create_age_meta.create_agedb(str(tmp_path / "ours"))) == \
        _rows(jcreate_age_meta.create_agedb(str(tmp_path / "theirs")))
    out = create_age_meta.main(["agedb", "--data_path", str(tmp_path / "ours")])
    assert _rows(out)[0] == ["age", "path"] and len(_rows(out)) == 3


def _age_rows(seed=0):
    rng = np.random.default_rng(seed)
    ages = np.concatenate([np.repeat(30, 600), np.repeat(70, 40), np.repeat(100, 4),
                           rng.integers(0, 125, 300)])
    rng.shuffle(ages)
    return [{"age": str(a), "path": f"img_{i}.jpg"} for i, a in enumerate(ages)]


@pytest.mark.parametrize("max_size,seed", [(150, 666), (30, 666), (5, 1)])
def test_balanced_splits_match_the_original(max_size, seed):
    import pandas as pd

    rows = _age_rows()
    ours = make_balanced_splits.make_balanced_testset(rows, max_size, seed)
    theirs = jmake_balanced_splits.make_balanced_testset(pd.DataFrame(rows), max_size, seed)
    assert [(r["age"], r["path"], r["split"]) for r in ours] == \
        list(zip(theirs["age"].tolist(), theirs["path"].tolist(), theirs["split"].tolist()))
    assert {r["split"] for r in ours} == {"train", "val", "test"}


def test_balanced_splits_cli_matches_the_original(tmp_path, monkeypatch):
    meta = tmp_path / "meta"
    meta.mkdir()
    with open(meta / "agedb.csv", "w", newline="") as fh:
        writer = csv.DictWriter(fh, ["age", "path"], lineterminator="\n")
        writer.writeheader()
        writer.writerows(_age_rows(1))
    out = make_balanced_splits.main(["--db", "agedb", "--data_path", str(tmp_path)])
    ours = _rows(out)
    monkeypatch.setattr(sys, "argv", ["make_balanced_splits", "--db", "agedb", "--data_path",
                                      str(tmp_path)])
    jmake_balanced_splits.main()  # overwrites the same file
    assert ours == _rows(out) and ours[0] == ["age", "path", "split"]


def test_nyud2_fds_subset_matches_the_original(tmp_path):
    for name in ("ours", "theirs"):
        d = tmp_path / name
        d.mkdir()
        (d / "nyu2_train.csv").write_text("".join(
            f"data/nyu2_train/scene_{i // 7}/{i}.jpg,data/nyu2_train/scene_{i // 7}/{i}.png\n"
            for i in range(50)))
    ours = preprocess_nyud2.create_fds_subset(str(tmp_path / "ours"), size=12, seed=3)
    theirs = jpreprocess_nyud2.create_fds_subset(str(tmp_path / "theirs"), size=12, seed=3)
    assert _rows(ours) == _rows(theirs) and len(_rows(ours)) == 12
    np.testing.assert_array_equal(np.load(tmp_path / "ours" / "FDS_train_subset_id.npy"),
                                  np.load(tmp_path / "theirs" / "FDS_train_subset_id.npy"))


def test_nyud2_balanced_mask_matches_the_original(tmp_path, monkeypatch):
    """On the test depths of 4 synthetic 16-bit PNGs, at the loader's crop."""
    rng = np.random.default_rng(0)
    d = tmp_path / "nyu2_test"  # the CSV's leading "data/" is the data dir
    d.mkdir()
    rows = []
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)).save(d / f"{i}.jpg")
        depth = rng.uniform(700, 10000, (240, 320)).astype(np.uint16)
        Image.fromarray(depth).save(d / f"{i}.png")
        rows.append(f"data/nyu2_test/{i}.jpg,data/nyu2_test/{i}.png\n")
    (tmp_path / "nyu2_test.csv").write_text("".join(rows))
    out = preprocess_nyud2.create_balanced_test_mask(str(tmp_path), seed=0)
    ours = np.load(out)
    theirs = np.load(jpreprocess_nyud2.create_balanced_test_mask(str(tmp_path), seed=0))
    assert ours.shape == (4, 228, 304) and ours.any()
    np.testing.assert_array_equal(ours, theirs)


def _tsv(path, seed=0, n=60):
    """GLUE STS-B layout; words only (no sentence-internal period, on which
    the JAX loader's punkt tokenizer may differ from the port's Treebank
    rules where punkt is installed)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(30)] + ["can't", "it's", "(x)"]
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("header\n")
        for _ in range(n):
            s1 = " ".join(rng.choice(words, rng.integers(3, 12))) + "."
            s2 = " ".join(rng.choice(words, rng.integers(3, 12)))
            fh.write("\t".join(["x"] * 7 + [s1, s2, f"{rng.uniform(0, 5):.3f}"]) + "\n")


def test_corpus_embeddings_match_the_original(tmp_path):
    _tsv(tmp_path / "train_new.tsv")
    outs = []
    for mod, name in ((corpus_embeddings, "ours.txt"), (jcorpus_embeddings, "theirs.txt")):
        mod.main(["--data_dir", str(tmp_path), "--out", str(tmp_path / name), "--dim", "8",
                  "--min_count", "2"])
        outs.append((tmp_path / name).read_text())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) > 20
    sents = [["a", "b", "c", "a"], ["b", "c", "d"], ["a", "d", "d", "b"]] * 3
    words, emb = corpus_embeddings.build_corpus_embeddings(sents, dim=3, min_count=1, seed=1)
    jwords, jemb = jcorpus_embeddings.build_corpus_embeddings(sents, dim=3, min_count=1, seed=1)
    assert words == jwords
    np.testing.assert_array_equal(emb, jemb)


def test_synth_corpus_matches_the_original(tmp_path):
    argv = ["--n", "30", "--val", "6", "--test", "6", "--src_size", "16", "--protos", "4",
            "--seed", "3"]
    out = make_synth_corpus.main(["--root", str(tmp_path / "ours"), *argv])
    jmake_synth_corpus.main(["--root", str(tmp_path / "theirs"), *argv])
    assert _rows(out) == _rows(tmp_path / "theirs" / "imdb_wiki.csv")
    assert _rows(out)[0] == ["age", "path", "split"] and len(_rows(out)) == 43
    for j in range(4):
        assert (tmp_path / "ours" / "data" / f"proto_{j}.jpg").read_bytes() == \
            (tmp_path / "theirs" / "data" / f"proto_{j}.jpg").read_bytes()
    assert len(os.listdir(tmp_path / "ours" / "data")) == 42 + 4


# -------------------------------------------------------------------- bench

def test_bench_on_the_cpu(monkeypatch, capsys):
    """Tiny model, batch and image: one JSON line with the bench's keys; K1
    and K2 once a step (the plain versions, counted here as the card's
    wrappers count their launches), K3 never."""
    for plain, wrapper in (("calibrate_indexed", ck.calibrate_forward),
                           ("calibrate_indexed_grad", ck.calibrate_backward)):
        real = getattr(ck, plain)

        def counted(*a, real=real, wrapper=wrapper, **k):
            wrapper.launches += 1
            return real(*a, **k)

        monkeypatch.setattr(ck, plain, counted)
    out = bench.main(["--device", "cpu", "--model", "resnet18", "--batch", "4", "--img", "32",
                      "--warmup", "2", "--steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert {"metric", "value", "unit", "host_ms_per_step", "device_ms_per_step", "launches",
            "device_name", "power_limit"} <= out.keys()
    assert out["unit"] == "img/s" and out["value"] > 0 and out["host_ms_per_step"] > 0
    assert np.isfinite(out["final_loss"])
    assert out["launches"] == {"calibrate_forward": 5, "calibrate_backward": 5,
                               "segment_moments": 0, "segment_moments_v2": 0,
                               "lstm_cell_forward": 0, "lstm_cell_backward": 0,
                               "moe_dispatch": 0, "moe_dispatch_backward": 0, "moe_combine": 0,
                               "moe_combine_backward": 0}
    assert out["device_ms_per_step"] is None and out["device_name"] is None
    assert bench.METRIC == "resnet50_fds_train_images_per_sec"


def test_bench_batch_is_the_jax_bench_batch():
    """The JAX bench's input, from the same generator and draws."""
    rng = np.random.default_rng(0)
    want = {"input": (rng.random((3, 8, 8, 3)) * 255).astype(np.uint8),
            "target": rng.integers(0, 100, size=(3, 1)).astype(np.float32),
            "weight": rng.uniform(0.5, 2.0, size=(3, 1)).astype(np.float32)}
    got = bench.bench_batch(3, 8)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------- no jax, pandas or tools

BLOCKED = ("jax", "flax", "pandas", "imbalanced_regression_tpu", "tools")
NEW_TOOLS = ("bench", "sweep", "aggregate_results", "sts_seeds", "create_age_meta",
             "make_balanced_splits", "preprocess_nyud2", "corpus_embeddings",
             "make_synth_corpus")
IMPORT_BLOCKED = """
import importlib, sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of it raises ImportError
modules, sys.argv[1:] = sys.argv[1:], ["--device", "cpu"]  # the tutorial script runs on import
for module in modules:
    importlib.import_module(module)
print(sorted(m for m, mod in sys.modules.items()
             if m.split(".")[0] in {blocked!r} and mod is not None))
"""


def _import_blocked(modules, blocked=BLOCKED):
    out = subprocess.run([sys.executable, "-c", IMPORT_BLOCKED.format(blocked=blocked), *modules],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("tool", NEW_TOOLS)
def test_tool_imports_no_jax_pandas_or_root_tools(tool):
    assert _import_blocked([f"imbalanced_regression_tpu_torch.tools.{tool}"]) == "[]"


def test_no_module_of_the_port_imports_jax_pandas_or_root_tools():
    modules = [m.name for m in pkgutil.walk_packages(imbalanced_regression_tpu_torch.__path__,
                                                     "imbalanced_regression_tpu_torch.")]
    assert "imbalanced_regression_tpu_torch.models.bilstm_pair" in modules
    assert _import_blocked(modules) == "[]"


@pytest.mark.parametrize("tool", ["create_sts_splits", "babysit", "download"])
def test_root_tools_that_run_on_the_card_as_they_are(tool):
    """The root tools the port does not copy import neither jax, flax,
    pandas nor the JAX package."""
    assert _import_blocked([f"tools.{tool}"], BLOCKED[:-1]) == "[]"
