"""The share of the STS-B BiLSTM's layer time steps whose forward cell ran
as the hand-written cell kernel (``csrc/lstm_cell.cu``
``lstm_cell_fwd_kernel``, layer: the LSTM recurrence of
``models/bilstm_pair.py`` ``FusedBiLSTM``): 100 x those kernels in the
benchmark's train spans of the profiled epoch, over ``n_layers_enc`` x
``max_seq_len`` x its steps (the indexed steps pad every pair to
``max_seq_len`` tokens). The two sizes come from the configuration of the
cells this metric lists in ``BENCHMARK.json``, which must agree. Nothing
where the trace holds no such kernel (a program whose cell runs as eager
ops); the stats pass's cells lie outside the train spans."""

from dirbench import spec

NAME = "fused_cell_pct"
KERNEL = "lstm_cell_fwd_kernel"
TRAIN_SPANS = ("train_epoch", "train_steps")


def layer_steps():
    """``n_layers_enc * max_seq_len`` of the configurations of this
    metric's cells, or None where they differ or it lists none."""
    bench = spec.load_spec()
    metric = next(m for m in bench["per_layer"] if m["name"] == NAME)
    sizes = set()
    for name in metric.get("workloads", []):
        recipe = spec.load_json("configs", spec.find_cell(bench, name)["config"])["recipe"]
        sizes.add(recipe["n_layers_enc"] * recipe["max_seq_len"])
    return sizes.pop() if len(sizes) == 1 else None


def read(obs):
    if obs.trace is None or not obs.profiled.get("steps"):
        return None
    events = obs.trace.events_in(obs.trace.spans_named(*TRAIN_SPANS))
    cells = sum(KERNEL in name for name, _, _ in events)
    per_step = layer_steps()
    if not cells or not per_step:
        return None
    return 100.0 * cells / (per_step * obs.profiled["steps"])
