"""
Autoregressive-baseline training (counterpart of
foldingdiff_tpu/training/ar_trainer.py; reference bin/train_autoregressive.py
and BertForAutoregressive._get_loss, modelling.py:896-968).

Each step draws, per item, causal_len = int(1 + u (length - 1)) with
u ~ U[0, 1) from the trainer's torch.Generator, clipped to [1, L - 1]; masks
the prefix before it; predicts the angle set at causal_len; and takes the
wrapped smooth-L1 loss (beta = pi/10) against the true angles there, over
the rows of non-zero length. The update is the diffusion trainer's
(trainer.optimizer_step: global-norm clip, AdamW at the schedule's rate).

The model and the generator live on one device; batches are numpy arrays
moved there per step, in np.random.default_rng(cfg.seed) order as in JAX.
Dropout draws from the device's default generator, seeded with cfg.seed for
the fit and restored after it.

With a mesh (parallel.mesh.Mesh) the trainer is data-parallel as the
diffusion Trainer is: every rank draws the whole batch's u, takes its rows of
the batch zero-padded to a multiple of the ranks, divides by the global
count of valid rows' elements and sums the gradients over the ranks; the
losses are the global batch's and only rank 0 writes. The zero padding makes
the exclusion of zero-length rows load-bearing. Dropout masks are each
rank's own (cfg.seed plus the rank).
"""
from __future__ import annotations

import logging
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from foldingdiff_tpu_torch import losses as loss_lib
from foldingdiff_tpu_torch.models.ar import BertForAutoregressive
from foldingdiff_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from foldingdiff_tpu_torch.parallel.multihost import is_primary
from foldingdiff_tpu_torch.training.trainer import (
    TrainConfig,
    append_metrics_csv,
    build_optimizer,
    dropout_rng,
    make_lr_schedule,
    optimizer_step,
    save_topk,
)

Batch = Dict[str, np.ndarray]
KEYS = ("angles", "attn_mask", "lengths")


def causal_lengths(u: torch.Tensor, lengths: torch.Tensor, pad: int) -> torch.Tensor:
    """int(1 + u (length - 1)) in float32, truncated toward zero, clipped to
    [1, pad - 1] (JAX's ar_trainer.py:65-69): a zero-length row clips to 1."""
    return (1 + u * (lengths.to(torch.float32) - 1)).to(torch.int64).clamp(1, pad - 1)


class ARTrainer:
    """Train and validation steps of the autoregressive baseline over stacked
    host arrays: dicts with "angles" (N, pad, F), "attn_mask" (N, pad) and
    "lengths" (N,), as AngleDataset.to_arrays() gives them."""

    def __init__(self, model: BertForAutoregressive, train_cfg: TrainConfig, steps_per_epoch: int,
                 mesh: Optional[Mesh] = None) -> None:
        self.model = model
        self.mesh = mesh
        if mesh is not None:
            replicate(mesh, model)  # rank 0's weights on every rank
        self.primary = is_primary()
        self.cfg = train_cfg
        self.device = next(model.parameters()).device
        self.lr_schedule = make_lr_schedule(train_cfg, steps_per_epoch)
        self.optimizer = build_optimizer(train_cfg, model.parameters())
        self.step = 0  # global step: the optimizer updates made so far
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)

    def to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device) for k in KEYS}

    def _loss(self, batch: Dict[str, torch.Tensor], causal_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The loss of a device batch in the model's current mode; causal_len
        (B,) drawn from the trainer's generator unless the caller gives it.
        Under a mesh the batch and causal_len are the global batch's and the
        loss this rank's share: summed over the ranks it is the global one."""
        if causal_len is None:
            u = torch.rand(batch["angles"].shape[0], generator=self.generator, device=self.device)
            causal_len = causal_lengths(u, batch["lengths"], batch["angles"].shape[1])
        causal_len = causal_len.to(self.device, torch.int64)
        count = None
        if self.mesh is not None:
            batch = dict(zip(batch, shard_batch(self.mesh, *batch.values())))
            causal_len = shard_batch(self.mesh, causal_len)
        angles, lengths = batch["angles"], batch["lengths"]
        b, l, f = angles.shape
        mask = (torch.arange(l, device=self.device)[None, :] < causal_len[:, None]).to(angles.dtype)
        preds = self.model(angles, mask, lengths)
        at = causal_len[:, None, None].expand(b, 1, f)
        pred_at, target = preds.gather(1, at)[:, 0], angles.gather(1, at)[:, 0]
        # Zero-length rows (a padded batch's) must not pull the model toward
        # zero angles: the per-row loss has no attention mask of its own
        valid = (lengths > 0)[:, None].expand_as(pred_at)
        if self.mesh is not None:
            count = self.mesh.all_reduce(valid.sum().to(angles.dtype))
        return loss_lib.radian_smooth_l1_loss(pred_at, target, beta=math.pi / 10, mask=valid, count=count)

    def _global(self, loss: torch.Tensor) -> torch.Tensor:
        """A loss summed over the ranks: the global batch's."""
        return loss if self.mesh is None else self.mesh.all_reduce(loss.clone())

    def train_step(self, batch: Dict[str, torch.Tensor], causal_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update from a device batch (the global batch under a mesh);
        returns the global batch's loss, detached on the device."""
        self.model.train()
        loss = self._loss(batch, causal_len)
        optimizer_step(self.model, self.optimizer, loss, self.cfg.gradient_clip, self.lr_schedule(self.step),
                       self.mesh)
        self.step += 1
        return self._global(loss.detach())

    def eval_step(self, batch: Dict[str, torch.Tensor], causal_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The loss of a device batch in eval mode (the attention kernel's
        route), without gradients."""
        self.model.eval()
        with torch.inference_mode():
            return self._global(self._loss(batch, causal_len))

    @staticmethod
    def _starts(n: int, batch_size: int) -> range:
        """Batch starts as JAX's fit makes them: full batches only, the ragged
        tail dropped, or one batch of all n when n < batch_size."""
        return range(0, max(n - batch_size + 1, 1), batch_size)

    def fit(
        self,
        train_data: Batch,
        valid_data: Optional[Batch] = None,
        results_dir: Optional[str] = None,
        train_args: Optional[dict] = None,
        mean_offset: Optional[np.ndarray] = None,
        log_every: int = 0,
        train_data_refresh: Optional[Callable[[int], Batch]] = None,
    ) -> List[Dict[str, float]]:
        """Train cfg.max_epochs epochs and return one metrics row per epoch
        (JAX's ar_trainer.py:95-183). The losses reach the host once per
        epoch. With results_dir it writes logs/metrics.csv and keeps the top 5
        checkpoints by validation loss (training loss without validation
        data) under models/best_by_valid: rank 0 only, under a mesh."""
        cfg = self.cfg
        self.generator.manual_seed(cfg.seed)
        host_rng = np.random.default_rng(cfg.seed)
        rows: List[Dict[str, float]] = []
        csv_flushed = 0
        best: List[Tuple[float, int, str]] = []
        writes = self.primary and results_dir is not None
        if writes:
            stale = os.path.join(results_dir, "logs", "metrics.csv")
            if os.path.exists(stale):
                os.remove(stale)
        with dropout_rng(self.device, cfg.seed, self.mesh):
            for epoch in range(cfg.max_epochs):
                t0 = time.time()
                if train_data_refresh is not None:  # per-epoch randomcrop re-crop
                    train_data = train_data_refresh(epoch)
                n = train_data["angles"].shape[0]
                idx = host_rng.permutation(n)
                losses = []
                for start in self._starts(n, cfg.batch_size):
                    sel = idx[start : start + cfg.batch_size]
                    losses.append(self.train_step(self.to_device({k: train_data[k][sel] for k in KEYS})))
                train_loss = float(torch.stack(losses).mean().cpu()) if losses else np.nan

                val_loss = np.nan
                if valid_data is not None:
                    nv = valid_data["angles"].shape[0]
                    vl = [self.eval_step(self.to_device({k: valid_data[k][s : s + cfg.batch_size] for k in KEYS}))
                          for s in self._starts(nv, cfg.batch_size)]
                    val_loss = float(torch.stack(vl).mean().cpu()) if vl else np.nan

                rows.append({"epoch": epoch, "step": self.step, "train_loss": train_loss, "val_loss": val_loss,
                             "epoch_seconds": time.time() - t0})
                if log_every and epoch % log_every == 0:
                    logging.info(f"AR epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f}")
                if writes:
                    csv_flushed = append_metrics_csv(results_dir, rows, already_flushed=csv_flushed)
                    metric = val_loss if valid_data is not None else train_loss
                    save_topk(self.model, results_dir, train_args or {}, mean_offset, epoch, metric, "valid", best)
        return rows
