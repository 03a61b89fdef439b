"""The time an epoch's train steps and stats pass wait for their next
staged batch: the program's ``input_wait`` spans (``Trainer._device_batches``:
taking the batch from ``prefetch_batches``' thread, and the current
stream's wait on its copy, ``StagedBatch.wait``) summed per epoch, the mean
over the window's epochs, those other than the profiled one and the first.
Nothing where the program records no such span (the indexed mode, which
gathers its batches on the device, stages none)."""


def read(obs):
    try:
        from imbalanced_regression_tpu_torch.utils.logging_tools import recorder
    except ImportError:
        return None
    window = {e["epoch"] for e in obs.epochs[1:] if not e["profiled"]}
    waits = recorder.closed("input_wait", epochs=window)
    if not waits:
        return None
    return sum(s.ms for s in waits) / len(window)
