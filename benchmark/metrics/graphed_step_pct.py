"""The share of train steps that replay a captured CUDA graph: the
program's ``replay`` spans (opened inside a ``step`` span by
``Trainer._graphed_update``) over its ``step`` spans, in percent, over the
window's epochs, those other than the profiled one and the first, whose
number the set-up's checked steps share. Nothing where the program records
no spans or has no graphed step (no ``StepGraphs`` in its ``train``
module)."""


def read(obs):
    try:
        from imbalanced_regression_tpu_torch.train import StepGraphs  # noqa: F401
        from imbalanced_regression_tpu_torch.utils.logging_tools import recorder
    except ImportError:
        return None
    window = {e["epoch"] for e in obs.epochs[1:] if not e["profiled"]}
    spans = recorder.closed("step", "replay", epochs=window)
    steps = sum(s.name == "step" for s in spans)
    if not steps:
        return None
    return 100.0 * sum(s.name == "replay" for s in spans) / steps
