"""``BENCHMARK.json`` against the shape it must have, and every name in it
resolving to its files."""

import json
import re

import pytest

from dirbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_spec()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = spec.find_cell(BENCH, cell)
    assert NAME.match(c["name"]) and NAME.match(c["traffic"]) and c["chips"] in (1, 4)
    assert 1 <= len(c["why"]) <= 200
    conf = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert conf["file"] == f"benchmark/configs/{c['config']}.json"
    config = spec.load_json("configs", c["config"])
    assert config["source"] == conf["source"] and config["reduced"] == conf["reduced"]
    spec.load_json("traffic", c["traffic"])
    limits = spec.load_json("limits", cell)
    assert limits and all(v > 0 for v in limits.values())
    family = spec.load_module("families", config["family"])
    assert hasattr(family, "Workload")
    assert spec.path_of("flops", config["family"]).exists()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_resolves_to_its_reader(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for cell in m.get("workloads", []):
        spec.find_cell(BENCH, cell)
    assert callable(spec.load_module("metrics", metric).read)


def test_end_to_end_metrics_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert names == ["train_samples_per_s", "setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_names_unique_and_roofline_names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[kind]]
        assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_every_config_used_and_files_distinct():
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
