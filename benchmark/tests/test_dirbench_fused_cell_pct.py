"""The reader of ``fused_cell_pct`` on hand-made traces: the forward cell
kernels of the train spans over ``n_layers_enc x max_seq_len`` a step (2 x
40 in the STS-B configuration), the stats pass's cells and the backward
kernels left out; nothing where the trace holds no cell kernel (a commit
whose cell runs as eager ops), where there is no trace, or where the
configurations of the metric's cells disagree on the sizes."""

import pytest

from dirbench import spec, trace

FWD = "void (anonymous namespace)::lstm_cell_fwd_kernel<__nv_bfloat16, 4>(__nv_bfloat16 const*)"
BWD = "void (anonymous namespace)::lstm_cell_bwd_kernel<__nv_bfloat16, 4>(__nv_bfloat16 const*)"
GEMM = "nvjet_tst_192x32_64x7_2x1_v_bz_NTT"


def summary(train_cells: int, pass_cells: int = 0, bwd: int = 0, span="train_steps"):
    """A train span [0, 5] and a stats pass [5, 10], with ``train_cells``
    forward cells (and ``bwd`` backward ones) and products in the first and
    ``pass_cells`` forward cells in the second."""
    events = [(GEMM, 0.0, 0.001)]
    events += [(FWD, 1.0 + i * 1e-4, 1.0 + (i + 0.5) * 1e-4) for i in range(train_cells)]
    events += [(BWD, 3.0 + i * 1e-4, 3.0 + (i + 0.5) * 1e-4) for i in range(bwd)]
    events += [(FWD, 6.0 + i * 1e-4, 6.0 + (i + 0.5) * 1e-4) for i in range(pass_cells)]
    events.sort(key=lambda e: e[1])
    merged = trace.merge((s, e) for _, s, e in events)
    spans = [(span, 0.0, 5.0), ("fds_pass", 5.0, 10.0)]
    return trace.TraceSummary(0.0, 10.0, events, merged, spans)


class Obs:
    def __init__(self, s, steps=3):
        self.trace = s
        self.profiled = {"steps": steps, "model_flops": 1.0, "kernel_calls": []}
        self.epochs = [{"profiled": True, "phases": {}}]


def read(obs):
    return spec.load_module("metrics", "fused_cell_pct").read(obs)


def test_the_stsb_configuration_runs_80_cells_a_step():
    assert spec.load_module("metrics", "fused_cell_pct").layer_steps() == 2 * 40


@pytest.mark.parametrize("span", ["train_steps", "train_epoch"])
@pytest.mark.parametrize("cells,want", [(240, 100.0), (120, 50.0), (3, 1.25)])
def test_fused_cell_pct_counts_forward_cells_of_the_train_spans(span, cells, want):
    obs = Obs(summary(cells, pass_cells=80, bwd=cells, span=span))
    assert read(obs) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no cell kernel", "only the pass's", "no trace", "no steps"])
def test_fused_cell_pct_reads_nothing_without_train_cells(case):
    obs = Obs(summary(0, pass_cells=80 if case == "only the pass's" else 0))
    if case == "no trace":
        obs.trace = None
    if case == "no steps":
        obs = Obs(summary(240), steps=0)
    assert read(obs) is None


def test_fused_cell_pct_reads_nothing_where_its_cells_disagree(monkeypatch):
    bench = spec.load_spec()
    cell = dict(spec.find_cell(bench, "stsb-bilstm.b128"), name="other", config="other")
    bench["workloads"].append(cell)
    for m in bench["per_layer"]:
        if m["name"] == "fused_cell_pct":
            m["workloads"] = ["stsb-bilstm.b128", "other"]
    load_json = spec.load_json

    def configs(kind, name):
        config = load_json(kind, "stsb-bilstm" if name == "other" else name)
        if name == "other":
            config["recipe"]["max_seq_len"] = 30
        return config

    monkeypatch.setattr(spec, "load_spec", lambda root=spec.ROOT: bench)
    monkeypatch.setattr(spec, "load_json", configs)
    assert read(Obs(summary(240))) is None
