"""The depth family: NYUD2-DIR dense depth training through the program's
``Trainer``, as ``tasks/nyud2.py`` ``run()`` drives it.

Inputs drawn from the seed: uint8 images (coloured fields with grain,
each at its own exposure), depth maps as smooth random fields, each with
its own offset, ranked onto a fixed multiset of depths whose 0.1-m buckets
hold the published train split's shares (``TRAIN_BUCKET_NUM``), the FDS
subset as the train rows of a seeded order, and test depths at the image
size, by the same law, with a balanced mask: an equal number of pixels
drawn from each bucket. The weights: He-normal, the final convolution at
PyTorch's default scale (``reference.depth.layout``). Images and rooms
that differ from one another, and first predictions near 0 m rather
than some 15 m off, are what let a step's loss, and the test maps, tell
one batch or image from another beyond bf16's own rounding: a half batch
and a stale staging slot are then seen on every seed read (PERF.md).

Set-up builds the trainer with ``tasks/nyud2.py``'s ``build_nyud_trainer``,
loads the weights drawn from the seed, runs two short stats passes (epochs
0 and 1) over the FDS subset's first batches, predicts the test split at
the drawn weights (``Trainer.predict``: the depth model's 114x152 output,
before any step, as the ResNet family validates; each image's map is
compared as the means of a coarse grid of patches, :func:`patch_means`),
then the three checked
steps, each one ``Trainer.train_epoch`` call over one batch, then one
``train_epoch`` call over ``RING_STEPS`` further batches, so a slot of the
staging ring is reused with batches in flight (its mean loss and the change
after all the steps are read), then two unread steps at each epoch where
the recipe's lr drops, so that every graph key the window steps under is
captured in set-up. A window epoch is ``train_epoch`` over the epoch's
shuffled batches, ``fds_epoch_pass`` over the FDS subset in order, and
``tasks/nyud2.py``'s ``test_epoch`` (host upsample to the test depth's
size, balanced mask, shot metrics)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dirbench.compare import Readings
from dirbench.inputs import counts_from_law, device_generator, draw_weights
from dirbench.spec import load_module
from dirbench.workload import CHECK_EPOCH, TrainingWorkload
from reference import depth as rdepth
from reference import optim as roptim
from reference import resnet as rresnet

RING_STEPS = 4  # one more than the 3 slots of the program's pinned staging ring


def field_images(n: int, hw, seed: int, device: torch.device, stream: int, cells: int,
                 grain: float, exposure: float, chunk: int = 256) -> np.ndarray:
    """``n`` NHWC uint8 images of ``hw`` drawn on the device and copied once
    to host memory: a random ``cells`` x ``cells`` colour image bilinearly
    upsampled, plus gaussian grain (``dirbench.inputs.uint8_images`` at a
    rectangular size), at the image's own exposure, as photographs of
    different rooms differ: its colours' spread around
    mid-grey scaled by ``exp(u * 0.7 * exposure)`` and shifted by ``v * 96
    * exposure`` levels, ``u`` and ``v`` uniform in [-1, 1]."""
    gen = device_generator(seed, device, stream)
    out = np.empty((n, *hw, 3), np.uint8)
    host = torch.from_numpy(out)
    for start in range(0, n, chunk):
        c = min(chunk, n - start)
        field = torch.rand((c, 3, cells, cells), generator=gen, device=device) * 255.0
        u, v = torch.rand((2, c, 1, 1, 1), generator=gen, device=device) * 2.0 - 1.0
        field = 127.5 + (field - 127.5) * torch.exp(u * 0.7 * exposure) + v * 96.0 * exposure
        img = F.interpolate(field, size=tuple(hw), mode="bilinear", align_corners=False)
        img = img + grain * torch.randn(img.shape, generator=gen, device=device)
        host[start:start + c].copy_(img.clamp_(0, 255).round_().to(torch.uint8)
                                    .permute(0, 2, 3, 1))
    return out


def depth_maps(n: int, hw, seed: int, device: torch.device, stream: int, bucket_start: int,
               cells: int, scene: float, chunk: int = 256) -> np.ndarray:
    """``n`` depth maps [n, h, w, 1] float32 in metres: a smooth random
    field per map (a ``cells`` x ``cells`` gaussian image bilinearly
    upsampled, plus the map's own offset of standard deviation ``scene``:
    how far its room reaches), its values over all maps ranked onto a fixed
    multiset of depths whose 0.1-m buckets from ``bucket_start`` on hold
    the shares of ``TRAIN_BUCKET_NUM`` (largest remainders), spread evenly
    inside each bucket: every seed draws the same histogram, in other
    places."""
    gen = device_generator(seed, device, stream)
    h, w = hw
    field = torch.empty((n, h, w), device=device)
    for start in range(0, n, chunk):
        c = min(chunk, n - start)
        small = torch.randn((c, 1, cells, cells), generator=gen, device=device)
        small = small + scene * torch.randn((c, 1, 1, 1), generator=gen, device=device)
        field[start:start + c] = F.interpolate(small, size=(h, w), mode="bilinear",
                                               align_corners=False)[:, 0]
    total = n * h * w
    counts = torch.as_tensor(counts_from_law(rdepth.TRAIN_BUCKET_NUM[bucket_start:], total),
                             device=device)
    bucket = torch.repeat_interleave(torch.arange(len(counts), device=device), counts)
    first = torch.cumsum(counts, 0) - counts
    j = torch.arange(total, device=device) - first[bucket]
    values = (bucket_start + bucket + (j + 0.5) / counts[bucket]).double() / 10.0
    depth = torch.empty(total, device=device)
    depth[torch.argsort(field.reshape(-1))] = values.float()
    return depth.view(n, h, w, 1).cpu().numpy()


def balanced_mask(depth: np.ndarray, seed: int, device: torch.device, bucket_start: int,
                  bucket_num: int) -> np.ndarray:
    """[n, h, w] bool: the same number of pixels from each 0.1-m bucket
    ``bucket_start .. bucket_num - 1`` (the least bucket's count), drawn at
    random from the seed, as ``test_balanced_mask.npy`` balances the test
    pixels over buckets 7-99."""
    d = torch.from_numpy(depth.reshape(-1)).to(device)
    bucket = rdepth.depth_bins(d, bucket_start, bucket_num - 1) - bucket_start
    counts = torch.bincount(bucket, minlength=bucket_num - bucket_start)
    keep = int(counts.min())
    gen = device_generator(seed, device, 7)
    key = bucket.double() + torch.rand(bucket.shape, generator=gen, device=device,
                                       dtype=torch.float64)
    order = torch.argsort(key)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(order), device=device) - first[bucket[order]]
    mask = torch.zeros(len(order), dtype=torch.bool, device=device)
    mask[order[rank < keep]] = True
    return mask.view(depth.shape[:3]).cpu().numpy()


def depth_buckets(target, bucket_start: int, bucket_num: int) -> np.ndarray:
    """The calibrate kernels' bucket index of every pixel of one batch
    (int8: the 93 buckets fit): ``clamp(trunc(10 d)) - bucket_start``."""
    t = np.asarray(target, np.float32).reshape(-1)
    scaled = (t * np.float32(10.0)).astype(np.int32)
    return (np.clip(scaled, bucket_start, bucket_num - 1) - bucket_start).astype(np.int8)


class Workload(TrainingWorkload):
    program_state = ("trainer", "state", "train", "fds_subset", "test")

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        super().__init__(config, traffic, seed, device)
        self.model, self.recipe = config["model"], config["recipe"]
        self.test_batch = self.recipe["test_batch_size"]

    # ------------------------------------------------------------ inputs
    def make_inputs(self) -> None:
        data, m, b, dev = self.config["data"], self.model, self.batch, self.device
        start, n = self.recipe["bucket_start"], data["train"]
        img_hw, depth_hw = tuple(m["img_hw"]), tuple(m["depth_hw"])
        look, scene = data["images"], data["depth_field"]
        self.train_images = field_images(n, img_hw, self.seed, dev, 2, **look)
        self.train_depth = depth_maps(n, depth_hw, self.seed, dev, 3, start, **scene)
        self.test_images = field_images(data["test"], img_hw, self.seed, dev, 4, **look)
        self.test_depth = depth_maps(data["test"], img_hw, self.seed, dev, 5, start, **scene)
        self.test_mask = balanced_mask(self.test_depth, self.seed, dev, start,
                                       self.recipe["bucket_num"])
        self.weights0 = draw_weights(list(rdepth.layout(tuple(m["stage_sizes"]), m["width"],
                                                        m["mff_features"])), self.seed, dev)
        # the FDS subset: train rows in a seeded order, as nyu2_train_FDS_subset.csv
        self.fds_rows = np.random.default_rng((self.seed, 3)).permutation(n)[:data["fds_subset"]]
        order = np.random.default_rng((self.seed, 2)).permutation(n)
        k = self.traffic["setup_pass_batches"]
        self.pass_rows = {e: [self.fds_rows[(e * k + i) * b:(e * k + i + 1) * b] for i in range(k)]
                          for e in (0, 1)}
        self.check_rows = [order[i * b:(i + 1) * b] for i in range(3)]
        self.ring_rows = [order[(3 + i) * b:(4 + i) * b] for i in range(RING_STEPS)]

    # ------------------------------------------------------------ program
    def _experiment(self):
        from imbalanced_regression_tpu_torch.tasks.nyud2 import NYUDConfig

        m = self.model
        return NYUDConfig(**self.recipe, batch_size=self.batch,
                          stage_sizes=tuple(m["stage_sizes"]), width=m["width"],
                          mff_features=m["mff_features"],
                          decoder_min_features=m["decoder_min_features"],
                          device=self.device.type, save_ckpt=0, seed=self.seed)

    def setup_program(self) -> None:
        from imbalanced_regression_tpu_torch.data.batching import eval_batches
        from imbalanced_regression_tpu_torch.tasks import nyud2

        self.exp = exp = self._experiment()
        self.train = {"input": self.train_images, "target": self.train_depth}
        self.fds_subset = {k: v[self.fds_rows] for k, v in self.train.items()}
        self.test = {"input": self.test_images, "target": self.test_depth, "mask": self.test_mask}
        self.trainer = trainer = nyud2.build_nyud_trainer(exp)
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
        test = {"input": self.test_images, "target": self.test_depth}
        preds, _ = trainer.predict(state, eval_batches(test, self.test_batch))
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
        self.program = Readings(losses, grads, changes, tables, patch_means(preds),
                                epoch_loss=ring_loss, epoch_change_norms=self.changes(params))
        for epoch in trainer.config.schedule:  # the lr's keys: an eager step, then a capture
            state, _ = trainer.train_epoch(state, iter([rows(r) for r in self.ring_rows[:2]]),
                                           epoch)
        self.state = state
        self.sync()

    def steps_per_epoch(self) -> int:
        return len(self.train_depth) // self.batch

    def run_epoch(self, epoch: int, spans, profiled: bool) -> dict:
        """One window epoch; returns its record (steps, samples, phase
        seconds, and for a profiled epoch the kernel calls and the model's
        operations)."""
        from imbalanced_regression_tpu_torch.data.batching import batch_iterator
        from imbalanced_regression_tpu_torch.tasks import nyud2

        b, rec = self.batch, {"epoch": epoch, "profiled": profiled}
        batches = batch_iterator(self.train, b, rng=np.random.default_rng((self.seed, epoch)))
        buckets = []
        if profiled:
            v1sum = self.state.fds.running_var_last_epoch.sum(1).cpu().numpy()
            batches = _recording(batches, buckets, self.exp.bucket_start, self.exp.bucket_num)
        with spans.span("train_epoch"):
            self.state, _ = self.trainer.train_epoch(self.state, batches, epoch)
        with spans.span("fds_pass"):
            self.state = self.trainer.fds_epoch_pass(
                self.state, batch_iterator(self.fds_subset, b, shuffle=False), epoch)
            self.sync()
        with spans.span("test"):
            nyud2.test_epoch(self.trainer, self.state, self.test, self.test_batch)
        steps = self.steps_per_epoch()
        rec.update(steps=steps, samples=steps * b, phases=spans.seconds(3))
        if profiled:
            rec.update(self._kernel_calls(buckets, v1sum, epoch))
        return rec

    def _kernel_calls(self, buckets, v1sum, epoch) -> dict:
        cfg, m, b = self.exp, self.model, self.batch
        d, nb = self.trainer.fds_config.feature_dim, cfg.bucket_num - cfg.bucket_start
        calls = []
        if cfg.fds and epoch >= cfg.start_smooth:
            ok = np.ones(buckets[0].size, bool) if buckets else None
            for e in buckets:
                for tables, per in ((4, 8), (2, 6)):  # K1 forward, K2 backward
                    calls.append({"kernel": "calibrate", "x_elt": 4, "e": e, "ok": ok,
                                  "v1sum": v1sum, "d": d, "tables": tables, "flops_per_elt": per})
        pixels = b * m["depth_hw"][0] * m["depth_hw"][1]
        passes = len(self.fds_rows) // b
        calls += [{"kernel": "moments", "n_valid": pixels, "n": pixels, "d": d, "b": nb}] * passes
        steps = self.steps_per_epoch()
        calls += [{"kernel": "resize", "n": b, **r}
                  for r in load_module("bytes", "resize").resizes(m)] * steps
        flops = load_module("flops", "depth").forward_flops(m)
        work = 3 * steps * b + passes * b + len(self.test_depth)
        return {"kernel_calls": calls, "model_flops": flops * work}

    # ------------------------------------------------------------ reference
    def reference(self, rounding: str | None = None) -> Readings:
        """The reference's readings over the same inputs: the two stats
        passes, the test predictions, the three steps and the
        ``RING_STEPS`` after them."""
        roptim.set_full_precision()
        dev, m, drv = self.device, self.model, self.recipe
        back0, head0 = self.weights0
        back = {k: v.clone() for k, v in back0.items()}
        head = {k: v.clone() for k, v in head0.items()}
        model = rdepth.DepthRegressor(back, head, tuple(m["stage_sizes"]), m["width"], rounding)
        hook_dim = head["conv.weight"].shape[1]
        fds = rdepth.depth_fds(drv, hook_dim, dev)
        table = rdepth.lds_bucket_weights(drv["reweight"], drv["lds_ks"], drv["lds_sigma"],
                                          drv["bucket_start"], drv["bucket_num"])
        images = lambda r: torch.from_numpy(self.train_images[r]).to(dev)  # noqa: E731
        depths = lambda r: torch.from_numpy(self.train_depth[r]).to(dev)  # noqa: E731

        for epoch in (0, 1):
            gen = torch.Generator(device=dev).manual_seed(epoch)
            with torch.no_grad():
                feats = [rdepth.rows_of(model.hook(rdepth.photometric(images(r), gen), True))
                         for r in self.pass_rows[epoch]]
            fds.update_last_epoch_stats(epoch)
            fds.update_running_stats(torch.cat(feats), torch.cat(
                [depths(r) for r in self.pass_rows[epoch]]), epoch)
            del feats
        tables = {"running_mean": fds.running_mean.cpu().numpy(),
                  "running_var": fds.running_var.cpu().numpy()}
        preds = self._test(model)
        # the reference at bf16 (rounding=None only): the scale of what the
        # configuration's own precision moves the predictions by
        preds_bf16 = None if rounding else self._test(rdepth.DepthRegressor(
            back, head, tuple(m["stage_sizes"]), m["width"], "bf16"))
        leaves = {**{f"backbone.{k}": v for k, v in back.items() if not rresnet.is_buffer(k)},
                  **{f"head.{k}": v for k, v in head.items()}}
        for v in leaves.values():
            v.requires_grad_(True)
        adam = roptim.Adam(leaves, lr=drv["lr"])
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        losses, grads, changes = [], {}, {}
        for k, r in enumerate(self.check_rows + self.ring_rows):
            depth = depths(r)
            hook = model.hook(rdepth.photometric(images(r), gen), True)
            hook = fds.smooth(rdepth.rows_of(hook), depth, CHECK_EPOCH).view(hook.shape)
            pred = model.predict(hook)
            loss = rdepth.weighted_mse(pred, depth, rdepth.pixel_weights(depth, table))
            g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            g = rdepth.with_l2(g, leaves, drv["weight_decay"])
            losses.append(loss.item())
            if k == 0:
                grads = {n: float(v.norm()) for n, v in g.items()}
            adam.step(leaves, g)
            del hook, pred, loss, g
            if k == len(self.check_rows) - 1:
                changes = self.changes(leaves)
        n = len(self.check_rows)
        return Readings(losses[:n], grads, changes, tables, preds, preds_bf16,
                        epoch_loss=float(np.mean(losses[n:])),
                        epoch_change_norms=self.changes(leaves))

    def _test(self, model) -> np.ndarray:
        """Each test image's mean prediction at the model's output size, in
        eval mode."""
        preds, b = [], self.batch
        with torch.no_grad():
            for s in range(0, len(self.test_images), b):
                x = rdepth.normalize(torch.from_numpy(self.test_images[s:s + b]).to(self.device))
                preds.append(patch_means(model.predict(model.hook(x, False)).cpu().numpy()))
        return np.concatenate(preds)


PATCH_GRID = (6, 8)  # 19 x 19-pixel patches of the 114 x 152 map


def patch_means(preds: np.ndarray, grid=PATCH_GRID) -> np.ndarray:
    """Each image's mean prediction (float64) over each patch of a coarse
    ``grid`` of its [H, W] map, [n, rows * cols]: what ``correct`` compares
    of the test predictions. Per pixel, bf16 alone moves a prediction by up
    to ~17% of the largest (the reference run in bf16 against float32),
    enough to hide a shift of 1 m of one image in eight; a patch's mean
    averages the rounding and keeps where it lies, so a mirrored or shifted
    map, which keeps every image's mean, is seen."""
    x = torch.as_tensor(np.asarray(preds), dtype=torch.float64).reshape(
        len(preds), 1, *np.shape(preds)[1:3])
    return F.adaptive_avg_pool2d(x, grid).reshape(len(preds), -1).numpy()


def _recording(batches, buckets: list, bucket_start: int, bucket_num: int):
    """``batches``, keeping each batch's pixel buckets (for the kernel
    counters); runs in the prefetch thread, beside the steps."""
    for batch in batches:
        buckets.append(depth_buckets(batch["target"], bucket_start, bucket_num))
        yield batch
