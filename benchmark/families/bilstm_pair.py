"""The BiLSTM sentence-pair family: STS-B-DIR training through the
program's ``Trainer`` in its indexed mode, as ``tasks/stsb.py`` runs it.

The corpus is drawn from the seed by the laws of ``chip_smoke.py``'s
``write_sts_corpus`` (copied here as token ids, with no tokenizer and no
file): words by a Zipf law over the vocabulary, 5-30 words a sentence with
commas and a final period, sentence 2 keeping a share score / 5 of
sentence 1's words, scores 5 * Beta(2, 5).

Set-up builds the trainer with ``tasks/stsb.py``'s ``build_sts_trainer``,
binds the train split to the device, loads the weights drawn from the
seed, runs two short stats passes (epochs 0 and 1), then the three checked
steps through ``train_step_indexed``. A window epoch is ``tasks/stsb.py``'s
loop of ``train_step_indexed`` over the endless shuffled index stream for
one epoch of drop-last batches, then ``fds_epoch_pass_indexed`` at the
rollover, each closed by a device synchronization as there."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dirbench.compare import Readings
from dirbench.inputs import draw_weights
from dirbench.spec import load_module
from dirbench.workload import CHECK_EPOCH, TrainingWorkload
from reference import bilstm as rbilstm
from reference import fds as rfds
from reference import optim as roptim

FIRST_WORD = 4  # ids: 0 padding, 1 unknown, 2 ".", 3 ",", then the words by rank
PERIOD, COMMA = 2, 3
HEARTBEAT = 100  # tasks/stsb.py reads the loss every 100 iterations


def draw_corpus(n: int, seed: int, corpus: dict, max_len: int):
    """(tokens1, mask1, tokens2, mask2, scores) of ``n`` pairs."""
    rng = np.random.default_rng((seed, 11))
    words = corpus["words"]
    cdf = np.cumsum(1.0 / np.arange(1, words + 1) ** corpus["zipf"])
    cdf /= cdf[-1]
    draw = lambda k: np.minimum(np.searchsorted(cdf, rng.random(k)), words - 1)  # noqa: E731
    scores = np.round(5.0 * rng.beta(2.0, 5.0, n), 3)
    scores[(scores >= 2.5) & (scores < 2.6)] += 0.1
    lo, hi = corpus["words_per_sentence"]
    len1 = rng.integers(lo, hi + 1, n)
    s1 = draw(len1.sum())
    keep = rng.random(len1.sum()) < np.repeat(scores / 5.0, len1)
    s2 = np.where(keep, s1, draw(len1.sum()))
    len2 = np.maximum(lo, len1 - rng.integers(0, 4, n))
    commas = rng.random((2, len1.sum())) < corpus["comma_share"]
    starts = np.concatenate([[0], np.cumsum(len1)[:-1]])
    out = [np.zeros((n, max_len), np.int32), np.zeros((n, max_len), np.float32),
           np.zeros((n, max_len), np.int32), np.zeros((n, max_len), np.float32)]
    for i in range(n):
        for col, (ids, length) in enumerate(((s1, len1[i]), (s2, len2[i]))):
            sel = slice(starts[i], starts[i] + length)
            toks = []
            for w, c in zip(ids[sel], commas[col, sel]):
                toks += [FIRST_WORD + int(w)] + ([COMMA] if c else [])
            toks = (toks + [PERIOD])[:max_len]
            out[2 * col][i, :len(toks)] = toks
            out[2 * col + 1][i, :len(toks)] = 1.0
    return (*out, scores.astype(np.float32))


class Workload(TrainingWorkload):
    backbone_prefix = "encoder."
    program_state = ("trainer", "state", "train", "stream")

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        super().__init__(config, traffic, seed, device)
        drv = config["recipe"]
        self.model = {"d_word": drv["d_word"], "d_hid": drv["d_hid"],
                      "n_layers": drv["n_layers_enc"], "max_seq_len": drv["max_seq_len"]}

    # ------------------------------------------------------------ inputs
    def make_inputs(self) -> None:
        data, b, m = self.config["data"], self.batch, self.model
        t1, m1, t2, m2, self.scores = draw_corpus(data["train"], self.seed, data["corpus"],
                                                  m["max_seq_len"])
        self.tokens = {"tokens1": t1, "mask1": m1, "tokens2": t2, "mask2": m2}
        self.vocab = FIRST_WORD + data["corpus"]["words"]
        enc, head = rbilstm.layout(self.vocab, m["d_word"], m["d_hid"], m["n_layers"])
        self.weights0 = draw_weights([enc, head], self.seed, self.device)
        self.weights0[0]["embed.weight"][0] = 0.0  # the padding row
        order = np.random.default_rng((self.seed, 2)).permutation(data["train"])
        k = self.traffic["setup_pass_batches"]
        self.check_rows = [order[i * b:(i + 1) * b] for i in range(3)]
        self.pass_rows = {e: [order[(3 + e * k + i) * b:(4 + e * k + i) * b] for i in range(k)]
                          for e in (0, 1)}
        self.real_tokens = m1.sum(1) + m2.sum(1)

    # ------------------------------------------------------------ program
    def setup_program(self) -> None:
        from imbalanced_regression_tpu_torch.data.batching import infinite_index_batches
        from imbalanced_regression_tpu_torch.ops.binning import bin_index_hist_np
        from imbalanced_regression_tpu_torch.ops.lds import prepare_weights_hist
        from imbalanced_regression_tpu_torch.tasks import stsb

        cfg = dataclasses.replace(stsb.STSConfig(), **self.config["recipe"], batch_size=self.batch,
                                  device=self.device.type, seed=self.seed)
        self.exp = cfg
        w = prepare_weights_hist(self.scores, cfg.reweight, bucket_num=cfg.bucket_num,
                                 lds=cfg.lds, lds_kernel=cfg.lds_kernel, lds_ks=cfg.lds_ks,
                                 lds_sigma=cfg.lds_sigma)
        self.train = {"input": self.tokens, "target": self.scores[:, None],
                      "bucket_idx": bin_index_hist_np(self.scores, cfg.bucket_num,
                                                      cfg.bucket_start),
                      "weight": w[:, None].astype(np.float32)}
        table = np.zeros((self.vocab, cfg.d_word), np.float32)
        self.trainer = trainer = stsb.build_sts_trainer(cfg, self.vocab, table)
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

    def run_epoch(self, epoch: int, spans, profiled: bool) -> dict:
        from imbalanced_regression_tpu_torch.data.batching import index_iterator

        rec, rows = {"epoch": epoch, "profiled": profiled}, []
        if profiled:
            v1sum = self.state.fds.running_var_last_epoch.sum(1).cpu().numpy()
        losses, preds = [], []
        with spans.span("train_steps"):
            for _ in range(self.n_batches):
                idx, _ = next(self.stream)
                self.state, loss, pred = self.trainer.train_step_indexed(self.state, idx, epoch)
                self.n_pass += 1
                losses.append(loss)
                preds.append((pred, self.train["target"][idx]))
                rows.append(idx)
                if self.n_pass % HEARTBEAT == 0:
                    loss.item()
            self.sync()
        pass_rows = list(index_iterator(len(self.scores), self.batch, rng=np.random.default_rng(
            self.seed * 10007 + epoch)))
        with spans.span("fds_pass"):
            self.state = self.trainer.fds_epoch_pass_indexed(self.state, iter(pass_rows), epoch)
            self.sync()
        rec.update(steps=self.n_batches, samples=self.n_batches * self.batch,
                   phases=spans.seconds(2))
        if profiled:
            rec.update(self._kernel_calls(rows, pass_rows, v1sum, epoch))
        return rec

    def _kernel_calls(self, rows, pass_rows, v1sum, epoch) -> dict:
        cfg, d = self.exp, 8 * self.model["d_hid"]
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
        counter = load_module("flops", "bilstm_pair")
        tokens = lambda rs: float(sum(self.real_tokens[r].sum() for r in rs))  # noqa: E731
        flops = 3 * counter.forward_flops(self.model, tokens(rows), sum(map(len, rows))) \
            + counter.forward_flops(self.model, tokens(pass_rows), sum(map(len, pass_rows)))
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
        model = rbilstm.PairRegressor(enc, head, m["n_layers"], drv["dropout"],
                                      drv["dropout_embs"], rounding)
        bucket_num = drv["bucket_num"]
        fds = rfds.FDS(rfds.FDSConfig(
            feature_dim=8 * m["d_hid"], bucket_num=bucket_num, bucket_start=0,
            start_update=drv["start_update"], start_smooth=drv["start_smooth"],
            ks=drv["fds_ks"], sigma=drv["fds_sigma"], momentum=drv["fds_mmt"],
            grouping="hist", clip_min=0.5, clip_max=2.0, guard="positive"), dev)
        weight = rfds.lds_weights_hist(self.scores, drv["reweight"], drv["lds_ks"],
                                       drv["lds_sigma"], bucket_num)
        buckets = torch.from_numpy(rfds.hist_bins(self.scores, bucket_num)).to(dev)
        batch = lambda r: {k: torch.from_numpy(v[r]).to(dev) for k, v in self.tokens.items()}  # noqa: E731
        for epoch in (0, 1):
            gen = torch.Generator(device=dev).manual_seed(epoch)
            with torch.no_grad():
                feats = [model.encode(batch(r), gen, train=True) for r in self.pass_rows[epoch]]
            fds.update_last_epoch_stats(epoch)
            fds.update_running_stats(torch.cat(feats), torch.cat(
                [buckets[torch.from_numpy(r).to(dev)] for r in self.pass_rows[epoch]]), epoch)
        tables = {"running_mean": fds.running_mean.cpu().numpy(),
                  "running_var": fds.running_var.cpu().numpy()}
        leaves = {**{f"encoder.{k}": v for k, v in enc.items() if k != "embed.weight"},
                  **{f"head.{k}": v for k, v in head.items()}}
        for v in leaves.values():
            v.requires_grad_(True)
        adam = roptim.Adam(leaves, lr=drv["lr"])
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        losses, grads = [], {}
        for k, r in enumerate(self.check_rows):
            rr = torch.from_numpy(r).to(dev)
            feat = fds.smooth(model.encode(batch(r), gen, train=True), buckets[rr], CHECK_EPOCH)
            pred = model.predict(feat)
            target = torch.from_numpy(self.scores[r]).to(dev)[:, None] / 5.0
            w = torch.from_numpy(weight[r]).to(dev)[:, None]
            loss = roptim.LOSSES[drv["loss"]](pred, target, w)
            g = roptim.clip_global_norm(list(torch.autograd.grad(loss, list(leaves.values()))),
                                        drv["max_grad_norm"])
            g = dict(zip(leaves, g))
            losses.append(loss.item())
            if k == 0:
                grads = {n: float(v.norm()) for n, v in g.items()}
            adam.step(leaves, g)
        return Readings(losses, grads, self.changes(leaves), tables)
