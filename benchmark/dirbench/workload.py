"""What the families' workloads share: the seed and the cell's files, the
planted-fault hook, and the program's readings taken from its own state
(the first gradient from Adam's first moment, the change from the drawn
weights)."""

from __future__ import annotations

import gc

import torch

ADAM_BETA1 = 0.9  # torch.optim.Adam's default, which the trainers use
CHECK_EPOCH = 2  # the checked steps and the window start after stats passes at epochs 0 and 1


class TrainingWorkload:
    """Base of a family's ``Workload``: ``make_inputs``, ``setup_program``,
    ``run_epoch``, ``release_program`` and ``reference`` in that order."""

    backbone_prefix = "backbone."
    program_state = ("trainer", "state", "train")

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.batch = traffic["batch_size"]
        self.after_build = None  # hook (trainer, state) -> None, for planted faults
        self.first_epoch = CHECK_EPOCH

    def named_parameters(self, state) -> dict:
        """The trained parameters by name (frozen ones left out)."""
        named = {**{self.backbone_prefix + n: p for n, p in state.backbone.named_parameters()},
                 **{f"head.{n}": p for n, p in state.head.named_parameters()}}
        return {n: p for n, p in named.items() if p.requires_grad}

    def start_weights(self) -> dict:
        back0, head0 = self.weights0
        return {**{self.backbone_prefix + n: t for n, t in back0.items()},
                **{f"head.{n}": t for n, t in head0.items()}}

    @staticmethod
    def first_gradients(state, params: dict) -> dict:
        """Each leaf's gradient norm as the optimizer got it in its first
        step: Adam's first moment is then ``(1 - beta1) * g``."""
        return {n: float(state.optimizer.state[p]["exp_avg"].norm()) / (1 - ADAM_BETA1)
                if p in state.optimizer.state else 0.0 for n, p in params.items()}

    def changes(self, params: dict) -> dict:
        start = self.start_weights()
        return {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release_program(self) -> None:
        """Free the program's state before the reference runs."""
        for name in self.program_state:
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
