"""The STS-B train step's time with the BiLSTM recurrence iterating over
``xw.unbind(1)`` (as ``models/bilstm_pair.py`` ships it) and over slices
``xw[:, t]`` (whose backward adds a zero-filled copy of the whole
[2B, L, 4H] gradient for every step), on one NVIDIA GPU (H100):

    python3 sts_probe.py

The full-width STS-B trainer (``tasks/stsb.py``'s: d_hid 1500, 2 layers,
bf16, a 12000-d pair embedding, FDS calibrating from a non-trivial
snapshot) on ``chip_smoke.py``'s synthetic corpus, batch 128, indexed
steps. The two forms run in the order unbind, slices, slices, unbind, each
window 3 warm-up steps and 10 timed ones on the host clock (synced at both
ends); then one profiled window of 5 steps of each gives the device's busy
time and its launches a step. Both forms compute the same forward; the
first step of each window from the same state gives the same loss, which
is checked. Prints the card's name and power limit, then one line per
measurement. Exits non-zero with no CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as smoke

ROOT = "runs/sts_probe"


def sliced_forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``FusedBiLSTM.forward`` with the step inputs taken as ``xw[:, t]``."""
    from imbalanced_regression_tpu_torch.models.bilstm_pair import _dense, flip_padded

    n_rows = x.shape[0]
    for layer in range(self.n_layers):
        xx = torch.cat([x, flip_padded(x, lengths)], dim=0)
        xw = _dense(xx, getattr(self, f"input_proj_{layer}"), self.dtype)
        wh = getattr(self, f"recurrent_kernel_{layer}").to(self.dtype)
        c = torch.zeros(xx.shape[0], self.hidden_size, device=x.device)
        h = torch.zeros_like(c)
        hs = []
        for t in range(xw.shape[1]):
            gates = (xw[:, t] + h.to(self.dtype) @ wh).float()
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        hs = torch.stack(hs, dim=1)
        out_b = flip_padded(hs[n_rows:], lengths)
        x = torch.cat([hs[:n_rows], out_b], dim=-1).to(self.dtype)
    return x


@contextlib.contextmanager
def recurrence(form: str):
    from imbalanced_regression_tpu_torch.models.bilstm_pair import FusedBiLSTM

    shipped = FusedBiLSTM.forward
    if form == "slices":
        FusedBiLSTM.forward = sliced_forward
    try:
        yield
    finally:
        FusedBiLSTM.forward = shipped


def host_window(trainer, state, batches, warmup: int = 3) -> tuple[float, float]:
    """(ms per step on the host clock, loss of the window's first step)."""
    first = None
    for idx in batches[:warmup]:
        _, loss, _ = trainer.train_step_indexed(state, idx, 2)
        first = loss.item() if first is None else first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in batches[warmup:]:
        trainer.train_step_indexed(state, idx, 2)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (len(batches) - warmup), first


def device_window(trainer, state, batches) -> tuple[float, int]:
    """(device busy ms per step, device activities per step) of a profiled
    window, after one warm-up step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer.train_step_indexed(state, batches[0], 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for idx in batches[1:]:
            trainer.train_step_indexed(state, idx, 2)
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    steps = len(batches) - 1
    return sum(times) / steps, len(times) // steps


def main() -> int:
    if not torch.cuda.is_available():
        print("sts_probe: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from imbalanced_regression_tpu_torch.data.batching import index_iterator
    from imbalanced_regression_tpu_torch.data.stsb import load_stsb_datasets
    from imbalanced_regression_tpu_torch.tasks import stsb
    from imbalanced_regression_tpu_torch.train import set_numerics

    set_numerics()
    data_dir = f"{ROOT}/data"
    smoke.write_sts_corpus(data_dir)
    argv = [a.replace(smoke.STS_DIR, data_dir) for a in smoke.STS_ARGV]
    cfg = stsb.parse_sts_config(argv)
    train, _, _, emb, vocab = load_stsb_datasets(cfg.data_dir, cfg)
    trainer = stsb.build_sts_trainer(cfg, len(vocab), emb)
    state = trainer.init_state(0)
    trainer.bind_device_data(train)
    n = len(train["target"])
    batches = lambda k: list(index_iterator(n, smoke.STS_BATCH, rng=np.random.default_rng(k)))  # noqa: E731
    for epoch in (0, 1):  # a non-trivial snapshot for the calibrating steps
        state = trainer.fds_epoch_pass_indexed(state, batches(epoch)[:4], epoch)
    window = batches(2)[:13]
    results = {"unbind": [], "slices": []}
    losses = {}
    start = copy.deepcopy({"backbone": state.backbone.state_dict(), "head": state.head.state_dict(),
                           "optimizer": state.optimizer.state_dict(),
                           "generator": state.generator.get_state(), "step": state.step})
    for form in ("unbind", "slices", "slices", "unbind"):
        # every window from the same weights, optimizer, generator and step
        state.backbone.load_state_dict(start["backbone"])
        state.head.load_state_dict(start["head"])
        state.optimizer.load_state_dict(copy.deepcopy(start["optimizer"]))
        state.generator.set_state(start["generator"])
        state.step = start["step"]
        with recurrence(form):
            ms, loss = host_window(trainer, state, window)
        results[form].append(ms)
        losses.setdefault(form, []).append(loss)
        print(f"{form}: {ms:.2f} ms/step on the host clock "
              f"({smoke.STS_BATCH * 1e3 / ms:.1f} pairs/s)", flush=True)
    assert len({*losses["unbind"], *losses["slices"]}) == 1, losses
    for form in ("unbind", "slices"):
        with recurrence(form):
            busy, launches = device_window(trainer, state, window[:6])
        print(f"{form}: device busy {busy:.2f} ms/step, {launches} device activities/step; host "
              f"{results[form]} ms/step", flush=True)
    shutil.rmtree(ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
