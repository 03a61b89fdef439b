"""The ResNet family: whole training epochs of the age suites
(IMDB-WIKI-DIR, AgeDB-DIR) through the program's ``Trainer``, as
``tasks/age.py`` runs them.

Set-up builds the trainer with ``tasks/age.py``'s ``build_trainer``, loads
the weights drawn from the seed, runs two short stats passes (epochs 0 and
1) so the window's steps calibrate against non-trivial statistics, one
validation pass (before any step: at the drawn weights both sides predict
from the same parameters, where after Adam's first steps they differ by
the signs of near-zero gradients), then the three checked steps, each one
``Trainer.train_epoch`` call over one batch (so each step's loss is read),
then one ``train_epoch`` call over ``RING_STEPS`` further batches, one more
than the staging ring's slots, so a slot is reused with batches in flight
as in the window (its mean loss and the change after all the steps are
read). These warm every shape the window uses. A window epoch is ``train_epoch``
over the epoch's shuffled batches, ``fds_epoch_pass`` over the train
split, and ``tasks/age.py``'s ``validate`` (predictions and shot metrics
on the host)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dirbench.compare import Readings
from dirbench.inputs import counts_from_law, draw_weights, uint8_images
from dirbench.spec import load_module
from dirbench.workload import CHECK_EPOCH, TrainingWorkload
from reference import fds as rfds
from reference import optim as roptim
from reference import resnet as rresnet

RING_STEPS = 4  # one more than the 3 slots of the program's pinned staging ring


def age_law(data: dict) -> np.ndarray:
    """The train split's share of each age: a gaussian bump over the ages
    and a thin floor (the configuration's ``train_law``)."""
    law = data["train_law"]
    ages = np.arange(data["ages"][0], data["ages"][1] + 1, dtype=np.float64)
    return np.exp(-0.5 * ((ages - law["mean"]) / law["sd"]) ** 2) + law["floor"]


class Workload(TrainingWorkload):
    program_state = ("trainer", "state", "train", "val")

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        super().__init__(config, traffic, seed, device)
        self.model = config["model"]

    # ------------------------------------------------------------ inputs
    def make_inputs(self) -> None:
        data, size, b = self.config["data"], self.model["img_size"], self.batch
        lo, hi = data["ages"]
        ages = np.arange(lo, hi + 1)
        rng = np.random.default_rng((self.seed, 1))
        train_labels = np.repeat(ages, counts_from_law(age_law(data), data["train"]))
        self.train_labels = rng.permutation(train_labels).astype(np.float32)
        val_labels = np.repeat(ages, counts_from_law(np.ones(len(ages)), data["val"]))
        self.val_labels = rng.permutation(val_labels).astype(np.float32)
        look = data["images"]
        self.train_images = uint8_images(data["train"], size, self.seed, self.device, 2, **look)
        self.val_images = uint8_images(data["val"], size, self.seed, self.device, 3, **look)
        back, head = rresnet.layout(tuple(self.model["stage_sizes"]), self.model["width"])
        self.weights0 = draw_weights([back, head], self.seed, self.device)
        order = np.random.default_rng((self.seed, 2)).permutation(data["train"])
        k = self.traffic["setup_pass_batches"]
        self.check_rows = [order[i * b:(i + 1) * b] for i in range(3)]
        self.pass_rows = {e: [order[(3 + e * k + i) * b:(4 + e * k + i) * b] for i in range(k)]
                          for e in (0, 1)}
        self.ring_rows = [order[(3 + 2 * k + i) * b:(4 + 2 * k + i) * b] for i in range(RING_STEPS)]

    # ------------------------------------------------------------ program
    def _experiment(self):
        from imbalanced_regression_tpu_torch.utils.config import defaults_for_dataset

        drv = dict(self.config["recipe"])
        drv["schedule"] = tuple(drv["schedule"])
        return dataclasses.replace(defaults_for_dataset(drv["dataset"]), **drv,
                                   batch_size=self.batch, img_size=self.model["img_size"],
                                   device=self.device.type, save_ckpt=0, seed=self.seed)

    def setup_program(self) -> None:
        from imbalanced_regression_tpu_torch.data.batching import eval_batches
        from imbalanced_regression_tpu_torch.ops.lds import prepare_weights_age
        from imbalanced_regression_tpu_torch.tasks import age

        exp = self._experiment()
        self.exp = exp
        w = prepare_weights_age(self.train_labels, exp.reweight, max_target=exp.max_target,
                                lds=exp.lds, lds_kernel=exp.lds_kernel, lds_ks=exp.lds_ks,
                                lds_sigma=exp.lds_sigma)
        self.train = {"input": self.train_images, "target": self.train_labels[:, None],
                      "weight": w[:, None].astype(np.float32)}
        self.val = {"input": self.val_images, "target": self.val_labels[:, None]}
        self.trainer = trainer = age.build_trainer(exp)
        state = trainer.init_state(self.seed)
        back0, head0 = self.weights0
        state.backbone.load_state_dict(back0)
        state.head.load_state_dict(head0)
        if self.after_build is not None:
            self.after_build(trainer, state)
        rows = lambda r: {k: v[r] for k, v in self.train.items()}  # noqa: E731
        for epoch in (0, 1):
            state = trainer.fds_epoch_pass(state, iter([rows(r) for r in self.pass_rows[epoch]]),
                                           epoch)
        tables = {"running_mean": state.fds.running_mean.cpu().numpy(),
                  "running_var": state.fds.running_var.cpu().numpy()}
        preds, _ = trainer.predict(state, eval_batches(self.val, self.batch))
        params = self.named_parameters(state)
        losses, grads = [], {}
        for k, r in enumerate(self.check_rows):
            state, loss = trainer.train_epoch(state, iter([rows(r)]), CHECK_EPOCH)
            losses.append(loss)
            if k == 0:
                grads = self.first_gradients(state, params)
        changes = self.changes(params)
        state, ring_loss = trainer.train_epoch(state, iter([rows(r) for r in self.ring_rows]),
                                               CHECK_EPOCH)
        self.program = Readings(losses, grads, changes, tables, preds.reshape(-1),
                                epoch_loss=ring_loss, epoch_change_norms=self.changes(params))
        self.state = state
        self.sync()

    def steps_per_epoch(self) -> int:
        return len(self.train_labels) // self.batch

    def run_epoch(self, epoch: int, spans, profiled: bool) -> dict:
        """One window epoch; returns its record (steps, samples, phase
        seconds, and for a profiled epoch the kernel calls and the model's
        operations)."""
        from imbalanced_regression_tpu_torch.data.batching import batch_iterator
        from imbalanced_regression_tpu_torch.tasks import age

        b, rec = self.batch, {"epoch": epoch, "profiled": profiled}
        batches = batch_iterator(self.train, b, rng=np.random.default_rng((self.seed, epoch)))
        targets = []
        if profiled:
            v1sum = self.state.fds.running_var_last_epoch.sum(1).cpu().numpy()
            batches = _recording(batches, targets)
        with spans.span("train_epoch"):
            self.state, _ = self.trainer.train_epoch(self.state, batches, epoch)
        with spans.span("fds_pass"):
            self.state = self.trainer.fds_epoch_pass(
                self.state, batch_iterator(self.train, b,
                                           rng=np.random.default_rng((self.seed, epoch, 1))),
                epoch)
            self.sync()
        with spans.span("validate"):
            age.validate(self.trainer, self.state, self.val, self.train_labels, b)
        steps = self.steps_per_epoch()
        rec.update(steps=steps, samples=steps * b, phases=spans.seconds(3))
        if profiled:
            rec.update(self._kernel_calls(targets, v1sum, epoch))
        return rec

    def _kernel_calls(self, targets, v1sum, epoch) -> dict:
        cfg, d, steps, b = self.exp, self.model["encoding"], self.steps_per_epoch(), self.batch
        nb = cfg.bucket_num - cfg.bucket_start
        calls = []
        if cfg.fds and epoch >= cfg.start_smooth:
            for t in targets:
                e, ok = age_buckets(t, cfg.bucket_start, cfg.bucket_num)
                for tables, per in ((4, 8), (2, 6)):  # K1 forward, K2 backward
                    calls.append({"kernel": "calibrate", "x_elt": 4, "e": e, "ok": ok,
                                  "v1sum": v1sum, "d": d, "tables": tables, "flops_per_elt": per})
        moments = [{"kernel": "moments", "n_valid": b, "n": b, "d": d, "b": nb}] * steps \
            if cfg.fds else []
        flops = load_module("flops", "resnet").forward_flops(self.model, self.model["img_size"])
        work = 3 * steps * b + steps * b + len(self.val_labels)
        return {"kernel_calls": calls + moments, "model_flops": flops * work}

    # ------------------------------------------------------------ reference
    def reference(self, rounding: str | None = None) -> Readings:
        """The reference's readings over the same inputs: the two stats
        passes, the validation predictions, the three steps and the
        ``RING_STEPS`` after them."""
        roptim.set_full_precision()
        dev, b, cfg, drv = self.device, self.batch, self.config, self.config["recipe"]
        back0, head0 = self.weights0
        back = {k: v.clone() for k, v in back0.items()}
        head = {k: v.clone() for k, v in head0.items()}
        model = rresnet.ResNetRegressor(back, head, tuple(self.model["stage_sizes"]),
                                        self.model["width"], rounding)
        fds = rfds.FDS(rfds.FDSConfig(
            feature_dim=self.model["encoding"], bucket_num=drv["bucket_num"],
            bucket_start=drv["bucket_start"], start_update=drv["start_update"],
            start_smooth=drv["start_smooth"], ks=drv["fds_ks"], sigma=drv["fds_sigma"],
            momentum=drv["fds_mmt"], grouping="age", clip_min=0.1, clip_max=10.0,
            guard="nonzero"), dev)
        weight = rfds.lds_weights_age(self.train_labels, drv["reweight"], drv["lds_ks"],
                                      drv["lds_sigma"], drv["max_target"])
        images = lambda r: torch.from_numpy(self.train_images[r]).to(dev)  # noqa: E731
        labels = lambda r: torch.from_numpy(self.train_labels[r]).to(dev)  # noqa: E731

        def augmented(r, gen):
            n = len(r)
            oy = torch.randint(0, 33, (n,), generator=gen, device=dev).tolist()
            ox = torch.randint(0, 33, (n,), generator=gen, device=dev).tolist()
            flips = (torch.rand((n,), generator=gen, device=dev) < 0.5).tolist()
            return rresnet.crop_flip_normalize(images(r), oy, ox, flips)

        for epoch in (0, 1):
            gen = torch.Generator(device=dev).manual_seed(epoch)
            with torch.no_grad():
                feats = [model.encode(augmented(r, gen), train=True) for r in self.pass_rows[epoch]]
            fds.update_last_epoch_stats(epoch)
            fds.update_running_stats(torch.cat(feats), torch.cat(
                [labels(r) for r in self.pass_rows[epoch]]), epoch)
        tables = {"running_mean": fds.running_mean.cpu().numpy(),
                  "running_var": fds.running_var.cpu().numpy()}
        preds = self._validate(model)
        # the reference at bf16 (rounding=None only): the scale of what the
        # configuration's own precision moves the predictions by
        preds_bf16 = None if rounding else self._validate(rresnet.ResNetRegressor(
            back, head, tuple(self.model["stage_sizes"]), self.model["width"], "bf16"))
        leaves = {**{f"backbone.{k}": v for k, v in back.items() if not rresnet.is_buffer(k)},
                  **{f"head.{k}": v for k, v in head.items()}}
        for v in leaves.values():
            v.requires_grad_(True)
        adam = roptim.Adam(leaves, lr=drv["lr"])
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        losses, grads, changes = [], {}, {}
        for k, r in enumerate(self.check_rows + self.ring_rows):
            t = labels(r)
            enc = fds.smooth(model.encode(augmented(r, gen), train=True), t, CHECK_EPOCH)
            pred = model.predict(enc)
            w = torch.from_numpy(weight[r]).to(dev)[:, None]
            loss = roptim.LOSSES[drv["loss"]](pred, t[:, None], w)
            g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            losses.append(loss.item())
            if k == 0:
                grads = {n: float(v.norm()) for n, v in g.items()}
            adam.step(leaves, g)
            if k == len(self.check_rows) - 1:
                changes = self.changes(leaves)
        n = len(self.check_rows)
        return Readings(losses[:n], grads, changes, tables, preds, preds_bf16,
                        epoch_loss=float(np.mean(losses[n:])),
                        epoch_change_norms=self.changes(leaves))

    def _validate(self, model) -> np.ndarray:
        preds, b = [], self.batch
        with torch.no_grad():
            for s in range(0, len(self.val_labels), b):
                x = rresnet.normalize(torch.from_numpy(self.val_images[s:s + b]).to(self.device))
                preds.append(model.predict(model.encode(x, train=False)).cpu().numpy())
        return np.concatenate(preds).reshape(-1)


def age_buckets(targets, bucket_start: int, bucket_num: int):
    """The calibrate kernels' bucket index and gate of one batch of ages:
    the edge buckets pool the ages beyond them, and act only when their
    exact edge age is in the batch."""
    t = np.asarray(targets, np.float32).reshape(-1)
    lo, hi = float(bucket_start), float(bucket_num - 1)
    e = np.clip(t.astype(np.int64) - bucket_start, 0, bucket_num - bucket_start - 1)
    ok = ((t > lo) & (t < hi)) | ((t <= lo) & np.any(t == lo)) | ((t >= hi) & np.any(t == hi))
    return e, ok


def _recording(batches, targets: list):
    """``batches``, keeping each batch's targets (for the kernel counters)."""
    for batch in batches:
        targets.append(batch["target"])
        yield batch
