"""The share of FDS stats-pass batches that replay a captured CUDA graph:
the program's ``pass_replay`` spans (opened inside a ``pass_batch`` span by
``Trainer._graphed_batch``) over its ``pass_batch`` spans, in percent, over
the window's epochs, those other than the profiled one and the first, whose
number the set-up's checked steps share. Nothing where the program records
no ``pass_batch`` span (a program whose stats pass opens none)."""


def read(obs):
    try:
        from imbalanced_regression_tpu_torch.utils.logging_tools import recorder
    except ImportError:
        return None
    window = {e["epoch"] for e in obs.epochs[1:] if not e["profiled"]}
    spans = recorder.closed("pass_batch", "pass_replay", epochs=window)
    batches = sum(s.name == "pass_batch" for s in spans)
    if not batches:
        return None
    return 100.0 * sum(s.name == "pass_replay" for s in spans) / batches
