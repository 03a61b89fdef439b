"""Host→device staging of train batches on CUDA: pinned memory and a side
stream.

:class:`PinnedStager` is the transform that ``prefetch_batches`` runs on its
background thread, one or two batches ahead of the step: it copies each
host array of a batch into a pinned buffer and sends it to the card with a
``non_blocking`` copy on a side stream, then records an event there. The
consumer takes the batch with :meth:`StagedBatch.wait`. Three invariants
hold:

- the compute stream waits on the batch's copy event before its first read
  (``wait_event``);
- each device tensor is marked as used by the compute stream
  (``record_stream``), so the caching allocator does not hand its block out
  again, to a later batch's copy on the side stream, while the step still
  reads it;
- a pinned buffer is written again only after the copy out of it has
  completed: the buffers are a ring of ``slots`` sets, and the producer
  synchronizes on a slot's last copy event before it refills the slot.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from imbalanced_regression_tpu_torch.data.batching import tree_map


class StagedBatch:
    """A batch whose copy to the device was enqueued on the side stream."""

    def __init__(self, tensors: dict, event: torch.cuda.Event, device: torch.device):
        self.tensors, self.event, self.device = tensors, event, device

    def wait(self) -> dict:
        """The device batch, safe to read on the current stream: that
        stream waits on the copy event, and every tensor is recorded as in
        use by it."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        tree_map(lambda t: t.record_stream(stream), self.tensors)
        return self.tensors


class PinnedStager:
    """Prefetch transform: a host batch (a possibly nested dict of arrays;
    ``count`` is dropped) → :class:`StagedBatch`. Runs on one thread at a
    time (the prefetch producer)."""

    def __init__(self, device: torch.device, stream: torch.cuda.Stream, slots: int = 3):
        self.device, self.stream = device, stream
        # per slot, the pinned buffer of each leaf, by the leaf's position
        self.buffers: list[dict[int, torch.Tensor]] = [{} for _ in range(slots)]
        self.events: list[torch.cuda.Event | None] = [None] * slots
        self.turn = 0
        self.allocations = 0  # pinned buffers allocated (reuse keeps this at slots x leaves)

    def __call__(self, batch: dict) -> StagedBatch:
        slot = self.turn
        self.turn = (slot + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()  # the copies out of this slot are done
        buffers, position = self.buffers[slot], itertools.count()

        def stage(value) -> torch.Tensor:
            key = next(position)
            host = torch.as_tensor(np.ascontiguousarray(value))
            pinned = buffers.get(key)
            if pinned is None or pinned.shape != host.shape or pinned.dtype != host.dtype:
                pinned = buffers[key] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                self.allocations += 1
            pinned.copy_(host)
            out = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            return out.copy_(pinned, non_blocking=True)

        with torch.cuda.stream(self.stream):
            tensors = tree_map(stage, {k: v for k, v in batch.items() if k != "count"})
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return StagedBatch(tensors, event, self.device)
