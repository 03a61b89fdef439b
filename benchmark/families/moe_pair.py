"""The DeepSeek-V2 sentence-pair family: STS-B-DIR training of a
DeepSeekMoE encoder (one chip's share of an expert-parallel deployment)
through the program's ``Trainer`` in its indexed mode, as ``tasks/stsb.py
--encoder deepseek_v2`` runs it.

The configuration file holds the model's published ``config.json`` keys at
its top level (``num_hidden_layers`` cut to the chip's pipeline stage),
``experts_held`` and ``expert_rank`` (the chip's experts), the STS-B recipe
and the corpus. The corpus is drawn from the seed by the BiLSTM family's
``draw_corpus`` (token ids by a Zipf law over the vocabulary's words, after
its 4 special ids); weights are drawn from the seed
(``reference.deepseek_v2.layout``).

Set-up builds the trainer with ``tasks/stsb.py``'s ``build_sts_trainer``,
loads the drawn weights, runs two short stats passes (epochs 0 and 1), then
the three checked steps through ``train_step_indexed``. A window epoch is
``tasks/stsb.py``'s loop of ``train_step_indexed`` over the endless shuffled
index stream for one epoch of drop-last batches, then
``fds_epoch_pass_indexed`` at the rollover, each closed by a device
synchronization. The profiled epoch zeroes the encoder's routing counters
(``routed_rows``, ``routed_tokens``) before its steps and reads them after
the steps and after the pass, to count the dispatch's bytes and the expert
products' operations. The reference runs each checked step over chunks of
``REFERENCE_CHUNK`` pairs, the gradients summed, so that its float32
activations fit beside its state."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dirbench.compare import Readings
from dirbench.inputs import draw_weights
from dirbench.spec import load_module
from dirbench.workload import CHECK_EPOCH, TrainingWorkload
from reference import deepseek_v2 as rdsv2
from reference import fds as rfds
from reference import optim as roptim

FIRST_WORD = 4  # ids: 0 padding, 1 unknown, 2 ".", 3 ",", then the words by rank
HEARTBEAT = 100  # tasks/stsb.py reads the loss every 100 iterations
REFERENCE_CHUNK = 32  # pairs a chunk of the reference's step
# the model keys the program's STSConfig takes (models/deepseek_v2.py DeepSeekV2Config)
MODEL_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "first_k_dense_replace",
              "intermediate_size", "moe_intermediate_size", "n_routed_experts",
              "n_shared_experts", "num_experts_per_tok", "experts_held", "expert_rank",
              "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
              "v_head_dim", "rms_norm_eps", "rope_theta", "initializer_range")


class Workload(TrainingWorkload):
    backbone_prefix = "encoder."
    program_state = ("trainer", "state", "train", "stream")

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        super().__init__(config, traffic, seed, device)
        self.model = {k: config[k] for k in (*MODEL_KEYS, "rope_scaling")}
        self.steps = config["recipe"]["max_seq_len"]

    # ------------------------------------------------------------ inputs
    def make_inputs(self) -> None:
        data, b = self.config["data"], self.batch
        draw_corpus = load_module("families", "bilstm_pair").draw_corpus
        t1, m1, t2, m2, self.scores = draw_corpus(data["train"], self.seed, data["corpus"],
                                                  self.steps)
        self.tokens = {"tokens1": t1, "mask1": m1, "tokens2": t2, "mask2": m2}
        if FIRST_WORD + data["corpus"]["words"] > self.model["vocab_size"]:
            raise ValueError("the corpus has more words than the vocabulary")
        self.weights0 = draw_weights(list(rdsv2.layout(self.model)), self.seed, self.device)
        order = np.random.default_rng((self.seed, 2)).permutation(data["train"])
        k = self.traffic["setup_pass_batches"]
        self.check_rows = [order[i * b:(i + 1) * b] for i in range(3)]
        self.pass_rows = {e: [order[(3 + e * k + i) * b:(4 + e * k + i) * b] for i in range(k)]
                          for e in (0, 1)}
        self.lengths = np.stack([m1.sum(1), m2.sum(1)], axis=1).astype(np.int64)  # [pairs, 2]

    # ------------------------------------------------------------ program
    def setup_program(self) -> None:
        from imbalanced_regression_tpu_torch.data.batching import infinite_index_batches
        from imbalanced_regression_tpu_torch.ops.binning import bin_index_hist_np
        from imbalanced_regression_tpu_torch.ops.lds import prepare_weights_hist
        from imbalanced_regression_tpu_torch.tasks import stsb

        cfg = dataclasses.replace(stsb.STSConfig(), **self.config["recipe"],
                                  **{k: self.model[k] for k in MODEL_KEYS},
                                  batch_size=self.batch, device=self.device.type, seed=self.seed)
        self.exp = cfg
        w = prepare_weights_hist(self.scores, cfg.reweight, bucket_num=cfg.bucket_num,
                                 lds=cfg.lds, lds_kernel=cfg.lds_kernel, lds_ks=cfg.lds_ks,
                                 lds_sigma=cfg.lds_sigma)
        self.train = {"input": self.tokens, "target": self.scores[:, None],
                      "bucket_idx": bin_index_hist_np(self.scores, cfg.bucket_num,
                                                      cfg.bucket_start),
                      "weight": w[:, None].astype(np.float32)}
        self.trainer = trainer = stsb.build_sts_trainer(cfg, self.model["vocab_size"], None)
        state = trainer.init_state(cfg.seed)
        enc0, head0 = self.weights0
        state.backbone.load_state_dict(enc0)
        state.head.load_state_dict(head0)
        if self.after_build is not None:
            self.after_build(trainer, state)
        trainer.bind_device_data(self.train)
        for epoch in (0, 1):
            state = trainer.fds_epoch_pass_indexed(state, iter(self.pass_rows[epoch]), epoch)
        tables = {"running_mean": state.fds.running_mean.cpu().numpy(),
                  "running_var": state.fds.running_var.cpu().numpy()}
        params = self.named_parameters(state)
        losses, grads = [], {}
        for k, r in enumerate(self.check_rows):
            state, loss, _ = trainer.train_step_indexed(state, r, CHECK_EPOCH)
            losses.append(float(loss))
            if k == 0:
                grads = self.first_gradients(state, params)
        self.program = Readings(losses, grads, self.changes(params), tables)
        self.state = state
        n = len(self.scores)
        self.n_batches = n // self.batch
        self.n_pass = self.first_epoch * self.n_batches
        self.stream = infinite_index_batches(n, self.batch, seed=111 + self.seed,
                                             start_batches=self.n_pass)
        self.sync()

    def steps_per_epoch(self) -> int:
        return self.n_batches

    def _counters(self):
        """(rows [layers] routed to the held experts, tokens [layers] with a
        held slot) so far, read from the encoder's device counters."""
        enc = self.state.backbone
        return (enc.routed_rows.sum(1).cpu().numpy().astype(np.float64),
                enc.routed_tokens.cpu().numpy().astype(np.float64))

    def run_epoch(self, epoch: int, spans, profiled: bool) -> dict:
        from imbalanced_regression_tpu_torch.data.batching import index_iterator

        rec, rows = {"epoch": epoch, "profiled": profiled}, []
        if profiled:
            v1sum = self.state.fds.running_var_last_epoch.sum(1).cpu().numpy()
            self.state.backbone.reset_counters()
        with spans.span("train_steps"):
            for _ in range(self.n_batches):
                idx, _ = next(self.stream)
                self.state, loss, _ = self.trainer.train_step_indexed(self.state, idx, epoch)
                self.n_pass += 1
                rows.append(idx)
                if self.n_pass % HEARTBEAT == 0:
                    loss.item()
            self.sync()
        counted = self._counters() if profiled else None
        pass_rows = list(index_iterator(len(self.scores), self.batch, rng=np.random.default_rng(
            self.seed * 10007 + epoch)))
        with spans.span("fds_pass"):
            self.state = self.trainer.fds_epoch_pass_indexed(self.state, iter(pass_rows), epoch)
            self.sync()
        rec.update(steps=self.n_batches, samples=self.n_batches * self.batch,
                   phases=spans.seconds(2))
        if profiled:
            after = self._counters()
            routed = {"steps": counted, "pass": tuple(a - s for a, s in zip(after, counted))}
            rec.update(self._kernel_calls(rows, pass_rows, v1sum, epoch, routed))
        return rec

    def _kernel_calls(self, rows, pass_rows, v1sum, epoch, routed) -> dict:
        cfg, m = self.exp, self.model
        d = 4 * m["hidden_size"]
        calls = []
        if cfg.fds and epoch >= cfg.start_smooth:
            for idx in rows:
                e = self.train["bucket_idx"][idx] - cfg.bucket_start
                ok = np.ones(len(idx), bool)
                for tables, per in ((4, 8), (2, 6)):  # K1 forward, K2 backward
                    calls.append({"kernel": "calibrate", "x_elt": 4, "e": e, "ok": ok,
                                  "v1sum": v1sum, "d": d, "tables": tables, "flops_per_elt": per})
        nb = cfg.bucket_num - cfg.bucket_start
        if cfg.fds:
            calls += [{"kernel": "moments", "n_valid": len(r), "n": len(r), "d": d, "b": nb}
                      for r in pass_rows]
        # each MoE layer's dispatch and combine, and its held experts'
        # products: forward in every step and pass batch, backward in steps
        positions = {"steps": 2 * self.steps * sum(map(len, rows)),
                     "pass": 2 * self.steps * sum(map(len, pass_rows))}
        for phase, backward in (("steps", True), ("pass", False)):
            layer_rows, layer_tokens = routed[phase]
            calls_a_layer = len(rows) if phase == "steps" else len(pass_rows)
            for r, u in zip(layer_rows, layer_tokens):
                call = {"calls": calls_a_layer, "tokens": positions[phase], "rows": float(r),
                        "touched": float(u), "d": m["hidden_size"], "k": m["num_experts_per_tok"],
                        "held": m["experts_held"], "width": m["moe_intermediate_size"],
                        "elt": 2, "backward": backward}
                calls += [{"kernel": "moe_dispatch", **call}, {"kernel": "expert_gemm", **call}]
        counter = load_module("flops", "moe_pair")
        lengths = lambda rs: self.lengths[np.concatenate(rs)].reshape(-1)  # noqa: E731
        flops = 3 * counter.forward_flops(m, lengths(rows)) \
            + counter.forward_flops(m, lengths(pass_rows))
        return {"kernel_calls": calls, "model_flops": flops}

    # ------------------------------------------------------------ reference
    def reference(self, rounding: str | None = None) -> Readings:
        """The reference's readings: the two stats passes and the three
        steps, over the same inputs."""
        roptim.set_full_precision()
        dev, drv, m = self.device, self.config["recipe"], self.model
        enc0, head0 = self.weights0
        enc = {k: v.clone() for k, v in enc0.items()}
        head = {k: v.clone() for k, v in head0.items()}
        model = rdsv2.PairRegressor(enc, head, m, rounding)
        bucket_num = drv["bucket_num"]
        fds = rfds.FDS(rfds.FDSConfig(
            feature_dim=4 * m["hidden_size"], bucket_num=bucket_num, bucket_start=0,
            start_update=drv["start_update"], start_smooth=drv["start_smooth"],
            ks=drv["fds_ks"], sigma=drv["fds_sigma"], momentum=drv["fds_mmt"],
            grouping="hist", clip_min=0.5, clip_max=2.0, guard="positive"), dev)
        weight = rfds.lds_weights_hist(self.scores, drv["reweight"], drv["lds_ks"],
                                       drv["lds_sigma"], bucket_num)
        buckets = torch.from_numpy(rfds.hist_bins(self.scores, bucket_num)).to(dev)
        batch = lambda r: {k: torch.from_numpy(v[r]).to(dev) for k, v in self.tokens.items()}  # noqa: E731
        for epoch in (0, 1):
            with torch.no_grad():
                feats = [model.encode(batch(r)) for r in self.pass_rows[epoch]]
            fds.update_last_epoch_stats(epoch)
            fds.update_running_stats(torch.cat(feats), torch.cat(
                [buckets[torch.from_numpy(r).to(dev)] for r in self.pass_rows[epoch]]), epoch)
            del feats
        tables = {"running_mean": fds.running_mean.cpu().numpy(),
                  "running_var": fds.running_var.cpu().numpy()}
        leaves = {**{f"encoder.{k}": v for k, v in enc.items() if rdsv2.trained(m, k)},
                  **{f"head.{k}": v for k, v in head.items()}}
        for v in leaves.values():
            v.requires_grad_(True)
        adam = roptim.Adam(leaves, lr=drv["lr"])
        losses, grads = [], {}
        for k, r in enumerate(self.check_rows):
            total, summed = 0.0, None
            for start in range(0, len(r), REFERENCE_CHUNK):
                part = r[start:start + REFERENCE_CHUNK]
                rr = torch.from_numpy(part).to(dev)
                feat = fds.smooth(model.encode(batch(part)), buckets[rr], CHECK_EPOCH)
                target = torch.from_numpy(self.scores[part]).to(dev)[:, None] / 5.0
                w = torch.from_numpy(weight[part]).to(dev)[:, None]
                # the batch's mean loss, as the sum of each chunk's share
                loss = roptim.LOSSES[drv["loss"]](model.predict(feat), target, w) \
                    * (len(part) / len(r))
                g = torch.autograd.grad(loss, list(leaves.values()))
                summed = list(g) if summed is None else [a.add_(b) for a, b in zip(summed, g)]
                total += loss.item()
                del g, feat, loss
            g = dict(zip(leaves, roptim.clip_global_norm(summed, drv["max_grad_norm"])))
            losses.append(total)
            if k == 0:
                grads = {n: float(v.norm()) for n, v in g.items()}
            adam.step(leaves, g)
            del g, summed
        return Readings(losses, grads, self.changes(leaves), tables)
