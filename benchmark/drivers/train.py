"""
Traffic kind "train": the training job's updates through the graphed step
that fit() runs (Trainer.train_steps, one update per call at fused_steps'
default), over host batches of the configuration's batch size drawn from a
seeded synthetic corpus held on the host: crops padded to the
configuration's max_seq_len, a `full_share` of them at full length and the
rest spread evenly over [min_len, max_seq_len), shuffled by the seed; the
angles wrapped N(0, 1), zero past each crop's length. Each epoch visits
the corpus in a seeded order. The trainer starts where LinearWarmup ends
(its step counter set as a resumed job's), so every update moves the
weights at the configuration's peak rate.

Set-up builds the trainer and runs its first `reference_steps` updates
through the same call on the corpus's first batches (the first captures
the graph); the reference follows them. The window's rate counts every
structure of every update over the time to the final synchronise.

Parameters (traffic/<name>.json): corpus (structures), full_share,
min_len, reference_steps.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import program, seeds, weights
from benchmark.harness.chains import ieee_float32
from benchmark.harness.trace import span
from benchmark.reference import denoiser, training
from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig


def corpus(config: dict, traffic: dict, seed: int) -> dict:
    pad, n = config["max_seq_len"], traffic["corpus"]
    n_full = int(round(n * traffic["full_share"]))
    lengths = np.concatenate([np.full(n_full, pad),
                              np.linspace(traffic["min_len"], pad, n - n_full, endpoint=False).astype(np.int64)])
    rng = seeds.rng(seed, "data")
    lengths = rng.permutation(lengths).astype(np.int64)
    n_ft = len(denoiser.FEATURES[config["angles_definitions"]])
    mask = (np.arange(pad)[None, :] < lengths[:, None]).astype(np.float32)
    angles = np.remainder(rng.standard_normal((n, pad, n_ft)) + np.pi, 2 * np.pi) - np.pi
    return {"angles": (angles * mask[..., None]).astype(np.float32), "attn_mask": mask, "lengths": lengths}


def train_config(config: dict, seed: int) -> TrainConfig:
    return TrainConfig(lr=config["lr"], loss=config["loss"], l2_norm=config["l2_norm"], l1_norm=config["l1_norm"],
                       circle_reg=config["circle_reg"], gradient_clip=config["gradient_clip"],
                       batch_size=config["batch_size"], max_epochs=config["max_epochs"],
                       lr_scheduler=config["lr_scheduler"], angular_variance=config["variance_scale"],
                       seed=seeds.derive(seed, "trainer"))


class Driver:
    def __init__(self, ctx):
        self.ctx, self.config, self.traffic = ctx, ctx.cell.config, ctx.cell.traffic
        if self.config.get("use_pdist_loss", 0.0):
            raise ValueError("the reference has no pdist term")
        self.data = corpus(self.config, self.traffic, ctx.seed)
        self.batch = self.config["batch_size"]
        self.per_epoch = self.data["lengths"].shape[0] // self.batch
        self.step0 = int(self.config["max_epochs"] * 0.1) * self.per_epoch
        self.order = []
        self.n_batches = 0

    def next_batch(self) -> dict:
        """The next batch of the seeded epochs, and its rows noted."""
        epoch, k = divmod(self.n_batches, self.per_epoch)
        if k == 0:
            self.perm = seeds.rng(self.ctx.seed, "data", 1 + epoch).permutation(self.data["lengths"].shape[0])
        rows = self.perm[k * self.batch:(k + 1) * self.batch]
        self.n_batches += 1
        self.order.append(rows)
        return {key: value[rows] for key, value in self.data.items()}

    def step(self, batch: dict) -> torch.Tensor:
        """One update through the call fit() makes: (1, 1 + F') losses."""
        if self.trainer.cuda_graphs:
            return self.trainer.train_steps([batch])
        loss, terms = self.trainer.train_step(self.trainer.to_device(batch))
        return torch.cat([loss[None], terms])[None]

    def setup(self) -> None:
        ctx = self.ctx
        self.model = program.model(self.config, weights.make(self.config, ctx.seed, ctx.device), ctx.device)
        schedule = program.schedule(self.config, ctx.device)
        self.trainer = Trainer(self.model, schedule, train_config(self.config, ctx.seed), self.per_epoch)
        self.trainer.step = self.step0
        params = dict(self.model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        torch.manual_seed(seeds.derive(ctx.seed, "dropout"))
        self.first = []
        for i in range(self.traffic["reference_steps"]):
            self.first.append(self.step(self.next_batch()))
            if i == 0:  # the clipped gradient, from AdamW's first moment: (1 - beta1) g; none, none given
                state = self.trainer.optimizer.state
                self.grad_norms = training.leaf_norms({
                    k: state[p]["exp_avg"] / (1 - training.BETAS[0]) if "exp_avg" in state.get(p, {})
                    else torch.zeros_like(p) for k, p in params.items()})
        self.change_norms = training.leaf_norms({k: p.detach() - start[k] for k, p in params.items()})
        self.first_terms = [out[0, 1:].tolist() for out in self.first]
        self.first = [float(out[0, 0]) for out in self.first]

    def window(self, seconds: float) -> None:
        outs = []
        self.t0 = time.perf_counter()
        while time.perf_counter() - self.t0 < seconds:
            with span("train.step"):
                outs.append(self.step(self.next_batch()))
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        self.t1 = time.perf_counter()
        self.updates = len(outs)
        self.losses = torch.cat(outs)[:, 0].cpu().numpy()

    def end_to_end(self) -> dict:
        return {"train_structures_per_s": self.updates * self.batch / (self.t1 - self.t0)}

    def counts(self):
        return self.updates, int((~np.isfinite(self.losses)).sum())

    def facts(self) -> dict:
        window_rows = self.order[-self.updates:]
        flops = 3 * sum(denoiser.matmul_flops(self.config, int(l)) for rows in window_rows
                        for l in self.data["lengths"][rows])
        return {"kind": "train", "window_s": self.t1 - self.t0, "updates": self.updates, "flops": flops,
                "config": self.config}

    def release(self) -> None:
        self.model = self.trainer = None

    def check(self) -> dict:
        ctx = self.ctx
        start = weights.make(self.config, ctx.seed, ctx.device)
        ref = training.Reference(start, self.config, seeds.derive(ctx.seed, "trainer"), self.per_epoch, self.step0)
        torch.manual_seed(seeds.derive(ctx.seed, "dropout"))
        losses, terms = [], []
        with ieee_float32():
            for i, rows in enumerate(self.order[:self.traffic["reference_steps"]]):
                batch = {k: torch.from_numpy(v[rows]).to(ctx.device) for k, v in self.data.items()}
                loss, grads = ref.update(batch)
                losses.append(loss)
                terms.append(ref.last_terms)
                if i == 0:
                    grad_norms = training.leaf_norms(grads)
        change = training.leaf_norms({k: p.detach() - start[k] for k, p in ref.params.items()})
        median = float(np.median(list(grad_norms.values())))
        moved = [k for k, g in grad_norms.items() if g >= 1e-3 * median]
        grad_gap, grad_leaf = training.worst_leaf_gap(self.grad_norms, grad_norms, list(grad_norms))
        change_gap, change_leaf = training.worst_leaf_gap(self.change_norms, change, moved)
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(self.first, losses)),
                "loss1_gap": abs(self.first[0] - losses[0]) / abs(losses[0]),
                "grad_gap": grad_gap, "change_gap": change_gap,
                "grad_median_gap": training.median_leaf_gap(self.grad_norms, grad_norms, list(grad_norms)),
                "change_median_gap": training.median_leaf_gap(self.change_norms, change, moved),
                "info": f"worst gradient leaf {grad_leaf}, worst change leaf {change_leaf}, "
                        f"{len(grad_norms) - len(moved)} leaves left out of the change; terms program "
                        f"{[[round(v, 6) for v in t] for t in self.first_terms]} reference "
                        f"{[[round(v, 6) for v in t] for t in terms]}"}
