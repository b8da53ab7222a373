"""
Diffusion training loop (counterpart of foldingdiff_tpu/training/trainer.py;
reference bin/train.py:287-507 and modelling.py:487-804).

- loss: per-feature wrapped smooth-L1 (beta = pi/10) of the predicted against
  the known noise over unmasked positions, meaned over features
  (modelling.py:553-706); optional circle penalty, L1 regularization and the
  pairwise-CA-distance auxiliary loss through the device NeRF
  (modelling.py:616-677)
- optax's update, written in PyTorch: the gradients clipped by their global
  norm (scaled by max / ||g|| when ||g|| >= max), then AdamW with
  weight_decay = l2_norm; the learning rate of update n is schedule(n),
  LinearWarmup stepped per epoch with 10% warmup, or optax's one-cycle cosine
- the pre-corrupted step of the debug noisers (train_step_precorrupted):
  the same update from a batch noised on the host, its loss the mean of the
  per-feature terms only
- top-5 checkpoints by validation and by training loss under
  models/best_by_{valid,train}/ (bin/train.py:214-233), SWA into
  best_by_swa, early stopping, a SIGTERM checkpoint, resume from the train
  state, and the metrics CSV with the JAX package's column names

The model and the schedule live on one device; batches are numpy arrays
moved there per step. Forward noising runs on the device from the trainer's
torch.Generator, seeded with cfg.seed at every fit, as the JAX package
starts its PRNGKey; batch order and crops come from numpy as in JAX. Dropout
draws from the device's default generator, seeded with cfg.seed for the fit
and restored after it. The time embedding's W is a buffer, so it is neither
optimized nor in the L1 norm, as JAX keeps it in `constants`.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import logging
import math
import os
import signal
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from foldingdiff_tpu_torch import losses as loss_lib
from foldingdiff_tpu_torch.diffusion.noise import corrupt_batch, q_sample, sample_wrapped_noise
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.geometry import nerf
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.bert import BertForDiffusion
from foldingdiff_tpu_torch.training import checkpoint


@dataclasses.dataclass
class TrainConfig:
    lr: float = 5e-5
    loss: str = "smooth_l1"  # smooth_l1 | l1
    l2_norm: float = 0.0
    l1_norm: float = 0.0
    circle_reg: float = 0.0
    gradient_clip: float = 1.0
    batch_size: int = 64
    min_epochs: Optional[int] = None
    max_epochs: int = 10000
    lr_scheduler: Optional[str] = "LinearWarmup"  # LinearWarmup | OneCycleLR | None
    early_stop_patience: int = 0
    use_pdist_loss: Any = 0.0  # float, or (min, max) interpolated over timesteps
    angular_variance: float = 1.0
    nonangular_variance: float = 1.0
    use_swa: bool = False  # stochastic weight averaging over the last 20% of epochs
    seed: int = 42
    # The JAX package runs K steps as one device program (lax.scan), which
    # its docstring calls identical math to K separate steps; here every
    # value runs the steps one by one. A CUDA graph of the step is later work.
    fused_steps: int = 1


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of the update at a global step, as the JAX package's
    schedules compute it in float32 (reference modelling.py:772-800)."""
    total_epochs = max(cfg.max_epochs, 1)
    f32 = np.float32
    if cfg.lr_scheduler is None:
        return lambda step: float(cfg.lr)
    if cfg.lr_scheduler == "LinearWarmup":
        warmup_epochs = int(total_epochs * 0.1)

        def linear_warmup(step: int) -> float:
            epoch = int(step) // max(steps_per_epoch, 1)
            if epoch < warmup_epochs:
                factor = min(f32(epoch) / f32(warmup_epochs), f32(1.0))
            else:
                decay = (f32(total_epochs) - f32(epoch)) / f32(max(total_epochs - warmup_epochs, 1))
                factor = min(max(decay, f32(0.0)), f32(1.0))
            return float(f32(cfg.lr) * factor)

        return linear_warmup
    if cfg.lr_scheduler == "OneCycleLR":
        # optax.cosine_onecycle_schedule(total_steps, peak_value=1e-2): cosine
        # from peak/25 up to peak over the first 30% of steps, then down to
        # peak/25/1e4, which it keeps after the last step. As in optax, the
        # node values and their half-differences are float64, the rest float32
        total_steps = total_epochs * max(steps_per_epoch, 1)
        bounds = (0, int(0.3 * total_steps), int(total_steps))
        values = np.cumprod([1e-2 / 25.0, 25.0, 1.0 / (25.0 * 1e4)])

        def one_cycle(step: int) -> float:
            for lo, hi, start, end in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
                if lo <= step < hi:
                    pct = f32(step - lo) / f32(hi - lo)
                    return float(f32(end) + f32((start - end) / 2.0) * (np.cos(f32(np.pi) * pct) + f32(1.0)))
            return float(f32(values[-1]))

        return one_cycle
    raise ValueError(f"Unknown lr scheduler {cfg.lr_scheduler}")


def build_optimizer(cfg: TrainConfig, params) -> torch.optim.AdamW:
    """AdamW with optax.adamw's constants and weight_decay = l2_norm; the
    trainer sets each update's learning rate from the schedule and clips the
    gradients first (clip_by_global_norm_)."""
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.l2_norm)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient times max / ||g||
    when the global norm ||g|| >= max, untouched below it (torch's
    clip_grad_norm_ uses max / (||g|| + 1e-6) instead). Returns ||g||; the
    host never waits for it."""
    g_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = (max_norm / g_norm).clamp(max=1.0)
    for g in grads:
        g.mul_(scale)
    return g_norm


def optimizer_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                   gradient_clip: float, lr: float) -> None:
    """Backward from `loss`, then the global-norm clip and the AdamW step at
    learning rate `lr`: one update of either trainer."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    with torch.profiler.record_function("optimizer"):
        if gradient_clip:
            clip_by_global_norm_([p.grad for p in model.parameters() if p.grad is not None], gradient_clip)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()


@contextlib.contextmanager
def dropout_rng(device: torch.device, seed: int):
    """The device's default generator (dropout's) seeded with `seed` while
    the block runs, its state restored after."""
    devices = [device.index or 0] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        yield


def save_topk(model: torch.nn.Module, results_dir: str, train_args: dict, mean_offset, epoch: int, metric: float,
              best_by: str, heap: List[Tuple[float, int, str]], k: int = 5) -> None:
    """Save the model's weights under best_by_{best_by} when `metric` enters
    the top k of `heap` (the set is not full, or it beats the current worst),
    deleting the checkpoint it pushes out. NaN never enters."""
    if np.isnan(metric) or not (len(heap) < k or metric < max(h[0] for h in heap)):
        return
    path = model_io.save_model_dir(results_dir, model.config, model.state_dict(), train_args,
                                   mean_offset=mean_offset, epoch=epoch, best_by=best_by, keep_top_k=10**9)
    heap.append((metric, epoch, path))
    heap.sort()
    while len(heap) > k:
        _, _, stale = heap.pop()
        if os.path.exists(stale):
            os.remove(stale)


def append_metrics_csv(results_dir: str, rows: List[Dict[str, float]], already_flushed: int = 0) -> int:
    """Append rows[already_flushed:] to <results_dir>/logs/metrics.csv,
    writing the header only when the file is new or empty; returns the new
    flushed count."""
    os.makedirs(os.path.join(results_dir, "logs"), exist_ok=True)
    out = os.path.join(results_dir, "logs", "metrics.csv")
    new_rows = rows[already_flushed:]
    if not new_rows:
        return already_flushed
    write_header = not os.path.exists(out) or os.path.getsize(out) == 0
    with open(out, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        if write_header:
            writer.writeheader()
        writer.writerows(new_rows)
    return len(rows)


def _per_feature_losses(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    is_angular: Sequence[bool],
    loss_name: str,
    circle_reg: float,
) -> torch.Tensor:
    """Per-feature masked losses, stacked (F,). Angular features take the
    wrapped loss with beta = pi/10 (modelling.py:228-233)."""
    terms = []
    for i, ang in enumerate(is_angular):
        p, t = pred[..., i], target[..., i]
        if loss_name == "smooth_l1":
            terms.append(loss_lib.radian_smooth_l1_loss(p, t, beta=math.pi / 10, circle_penalty=circle_reg, mask=mask)
                         if ang else loss_lib.smooth_l1_loss(p, t, beta=1.0, mask=mask))
        elif loss_name == "l1":
            terms.append(loss_lib.radian_l1_loss(p, t, mask=mask) if ang else loss_lib.l1_loss(p, t, mask=mask))
        else:
            raise ValueError(f"Unknown loss {loss_name}")
    return torch.stack(terms)


Batch = Dict[str, np.ndarray]


class Trainer:
    """
    Train and validation steps over stacked host arrays: dicts with "angles"
    (N, pad, F), "attn_mask" (N, pad) and "lengths" (N,), as
    AngleDataset.to_arrays() gives them.
    """

    def __init__(
        self, model: BertForDiffusion, schedule: DiffusionSchedule, train_cfg: TrainConfig, steps_per_epoch: int
    ) -> None:
        self.device = schedule.betas.device
        devices = {p.device for p in model.parameters()}
        if devices != {self.device}:
            raise ValueError(f"model parameters on {devices}, schedule on {self.device}")
        self.model = model
        self.schedule = schedule
        self.cfg = train_cfg
        self.lr_schedule = make_lr_schedule(train_cfg, steps_per_epoch)
        self.optimizer = build_optimizer(train_cfg, model.parameters())
        self.step = 0  # global step: the optimizer updates made so far
        self.is_angular = tuple(model.config.ft_is_angular)
        self.ft_names = tuple(model.config.ft_names)
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        self._csv_rows_flushed = 0

    @property
    def use_pdist(self) -> bool:
        p = self.cfg.use_pdist_loss
        return (p[0] if isinstance(p, (list, tuple)) else p) > 0

    def to_device(self, batch: Batch, keys: Sequence[str] = ("angles", "attn_mask", "lengths")
                  ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device) for k in keys}

    # -- core loss ----------------------------------------------------------
    def _predict(self, batch, t=None, noise=None):
        """(corrupted, pred, t, noise) for a device batch; t and noise drawn
        from the trainer's generator unless the caller gives both."""
        x0 = batch["angles"]
        if (t is None) != (noise is None):
            raise ValueError("give both t and noise, or neither")
        if t is None:
            c = corrupt_batch(self.generator, x0, self.schedule, self.is_angular,
                              self.cfg.angular_variance, self.cfg.nonangular_variance)
            corrupted, t, noise = c["corrupted"], c["t"], c["known_noise"]
        else:
            corrupted = q_sample(x0, t, noise, self.schedule, self.is_angular)
        return corrupted, self.model(corrupted, t, batch["attn_mask"]), t, noise

    def _loss_terms(self, batch, t=None, noise=None) -> torch.Tensor:
        """(F,) per-feature losses, plus the pdist term when it is on, in the
        model's current mode."""
        corrupted, pred, t, noise = self._predict(batch, t, noise)
        terms = _per_feature_losses(pred, noise, batch["attn_mask"], self.is_angular, self.cfg.loss,
                                    self.cfg.circle_reg)
        if self.use_pdist:
            terms = torch.cat([terms, self._pdist_loss(batch, corrupted, pred, t)[None]])
        return terms

    def _pdist_loss(self, batch, corrupted, pred, t) -> torch.Tensor:
        """Auxiliary pairwise-CA-distance loss (modelling.py:616-677), on the
        zero-centred angles as in the JAX package."""
        cfg, names = self.cfg, list(self.ft_names)
        sqrt_ac = self.schedule.sqrt_alphas_cumprod[t][:, None, None]
        sqrt_omac = self.schedule.sqrt_one_minus_alphas_cumprod[t][:, None, None]
        denoised = (corrupted - sqrt_omac * pred) / sqrt_ac

        def build(angles):
            return nerf.nerf_build_batch(
                phi=angles[:, :, names.index("phi")],
                psi=angles[:, :, names.index("psi")],
                omega=angles[:, :, names.index("omega")],
                bond_angle_n_ca_c=angles[:, :, names.index("tau")],
                bond_angle_ca_c_n=angles[:, :, names.index("CA:C:1N")],
                bond_angle_c_n_ca=angles[:, :, names.index("C:1N:1CA")],
            )

        with torch.no_grad():  # the data's own chain takes no gradient
            inferred_ca = build(batch["angles"])[:, 1::3, :]
        denoised_ca = build(denoised)[:, 1::3, :]
        if isinstance(cfg.use_pdist_loss, (list, tuple)):
            min_c, max_c = cfg.use_pdist_loss[:2]
            max_t = self.schedule.timesteps
            coef = min_c + (max_c - min_c) * ((max_t - t.float()) / max_t)
        else:
            coef = float(cfg.use_pdist_loss)
        return loss_lib.pairwise_dist_loss(denoised_ca, inferred_ca, lengths=batch["lengths"], weights=coef)

    def l1_penalty(self) -> torch.Tensor:
        """The sum of |p| over the parameters (the time embedding's W buffer
        is not one). Its gradient at p = 0 is +1, as jnp.abs's is."""
        return sum(torch.where(p >= 0, p, -p).sum() for p in self.model.parameters())

    def _update(self, loss: torch.Tensor) -> None:
        """One clipped AdamW update from `loss` at the schedule's learning rate."""
        # optax reads the count before its increment
        optimizer_step(self.model, self.optimizer, loss, self.cfg.gradient_clip, self.lr_schedule(self.step))
        self.step += 1

    def train_step(self, batch, t=None, noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update from a device batch: (loss, per-feature terms), both
        detached on the device. The loss includes the L1 penalty, as JAX's."""
        self.model.train()
        terms = self._loss_terms(batch, t, noise)
        avg = terms.mean()
        if self.cfg.l1_norm > 0:
            avg = avg + self.cfg.l1_norm * self.l1_penalty()
        self._update(avg)
        return avg.detach(), terms.detach()

    # -- pre-corrupted path (debug noisers) ----------------------------------
    def _loss_terms_precorrupted(self, batch) -> torch.Tensor:
        """(F,) per-feature losses of a host-noised device batch, which
        carries "corrupted", "t", "known_noise" and "attn_mask" (the
        reference's dataset-noising contract, datasets.py:873-879), in the
        model's current mode."""
        pred = self.model(batch["corrupted"], batch["t"].reshape(-1), batch["attn_mask"])
        is_angular = self.is_angular[: pred.shape[-1]]
        return _per_feature_losses(pred, batch["known_noise"], batch["attn_mask"], is_angular, self.cfg.loss,
                                   self.cfg.circle_reg)

    def train_step_precorrupted(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update from a host-noised device batch (the debug noisers'):
        (loss, per-feature terms), both detached on the device. The loss is
        the mean of the terms, without the L1 penalty, as JAX's."""
        self.model.train()
        terms = self._loss_terms_precorrupted(batch)
        avg = terms.mean()
        self._update(avg)
        return avg.detach(), terms.detach()

    def eval_step(self, batch, t=None, noise=None) -> torch.Tensor:
        """Loss terms of a device batch in eval mode, without gradients."""
        self.model.eval()
        with torch.inference_mode():
            return self._loss_terms(batch, t, noise)

    def eval_exhaustive_t(self, data: Batch, n_t: int = 16, seed: int = 0) -> np.ndarray:
        """Low-variance validation: per-feature losses averaged over a
        stratified grid of timesteps (the reference's exhaustive-t mode,
        datasets.py:812-825), each batch weighted by its unmasked positions."""
        ts = np.linspace(0, self.schedule.timesteps - 1, num=n_t).astype(np.int32)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        n, bs = data["angles"].shape[0], self.cfg.batch_size
        all_terms, weights = [], []
        self.model.eval()
        with torch.inference_mode():
            for t in ts:
                for start in range(0, n, bs):
                    batch = self.to_device({k: data[k][start : start + bs] for k in ("angles", "attn_mask", "lengths")})
                    b = batch["angles"].shape[0]
                    noise = sample_wrapped_noise(gen, tuple(batch["angles"].shape), self.is_angular,
                                                 self.cfg.angular_variance, self.cfg.nonangular_variance)
                    _, pred, _, _ = self._predict(batch, torch.full((b,), int(t), device=self.device), noise)
                    all_terms.append(_per_feature_losses(pred, noise, batch["attn_mask"], self.is_angular,
                                                         self.cfg.loss, self.cfg.circle_reg))
                    weights.append(float(np.sum(data["attn_mask"][start : start + bs])))
        return np.average(torch.stack(all_terms).cpu().numpy(), axis=0, weights=weights)

    # -- epoch loops ---------------------------------------------------------
    def _batches(self, data: Batch, rng: np.random.Generator, shuffle: bool) -> Iterator[Tuple[Batch, float]]:
        """(host batch, weight) in rng.permutation order (or in order), the
        ragged tail kept (reference DataLoader drop_last=False); weight is
        the batch's unmasked-position count."""
        n = data["angles"].shape[0]
        idx = rng.permutation(n) if shuffle else np.arange(n)
        bs = self.cfg.batch_size
        for start in range(0, n, bs):
            sel = idx[start : start + bs]
            batch = {k: data[k][sel] for k in ("angles", "attn_mask", "lengths")}
            yield batch, float(np.sum(batch["attn_mask"]))

    def fit(
        self,
        train_data: Batch,
        valid_data: Optional[Batch] = None,
        results_dir: Optional[str] = None,
        train_args: Optional[dict] = None,
        mean_offset: Optional[np.ndarray] = None,
        log_every: int = 0,
        resume: bool = False,
        save_state_every: int = 0,
        write_preds_to_dir: Optional[str] = None,
        exhaustive_t_validation: bool = False,
        exhaustive_t_points: int = 16,
        train_data_refresh: Optional[Callable[[int], Batch]] = None,
    ) -> List[Dict[str, float]]:
        """Train from the current step to cfg.max_epochs (or an early stop)
        and return one metrics row per epoch. With results_dir it writes the
        CSV and the top-5 model directories there; with resume it continues
        from the newest train state there."""
        cfg = self.cfg
        self.generator.manual_seed(cfg.seed)
        host_rng = np.random.default_rng(cfg.seed)
        rows: List[Dict[str, float]] = []

        # On SIGTERM finish the epoch, save the train state and stop; a run
        # with resume=True continues from it
        preempted = {"flag": False}
        previous_handler = None
        if results_dir is not None:
            def _on_term(signum, frame):
                logging.warning(f"Signal {signum}: checkpointing train state at epoch end")
                preempted["flag"] = True

            try:
                previous_handler = signal.signal(signal.SIGTERM, _on_term)
            except ValueError:
                pass  # not the main thread

        start_epoch = 0
        if resume and results_dir is not None:
            path = checkpoint.latest_train_state(results_dir)
            if path is not None:
                self.step, start_epoch = checkpoint.restore_train_state(path, self.model, self.optimizer)
                logging.info(f"Resumed train state from {path} at epoch {start_epoch}")
        # metrics.csv is appended to per epoch: a resumed run continues the
        # file, a fresh run into a used results_dir truncates it
        self._csv_rows_flushed = 0
        if results_dir is not None and start_epoch == 0:
            stale = os.path.join(results_dir, "logs", "metrics.csv")
            if os.path.exists(stale):
                os.remove(stale)
        pseudo_names = list(self.ft_names) + (["pairwise_dist_loss"] if self.use_pdist else [])

        best_valid: List[Tuple[float, int, str]] = []
        best_train: List[Tuple[float, int, str]] = []
        patience_count, best_val_loss = 0, float("inf")
        # SWA (reference StochasticWeightAveraging, bin/train.py:236-243):
        # the parameters averaged over the last 20% of epochs, on the device
        swa_start = int(cfg.max_epochs * 0.8)
        swa_params: Optional[Dict[str, torch.Tensor]] = None
        swa_count = 0

        try:
            with dropout_rng(self.device, cfg.seed):
                for epoch in range(start_epoch, cfg.max_epochs):
                    t0 = time.time()
                    if train_data_refresh is not None:  # per-epoch randomcrop re-crop
                        train_data = train_data_refresh(epoch)
                    # Losses stay on the device until the epoch ends: one host sync per epoch
                    step_losses = [self.train_step(self.to_device(batch))
                                   for batch, _ in self._batches(train_data, host_rng, shuffle=True)]
                    if step_losses:
                        train_loss = float(torch.stack([a for a, _ in step_losses]).mean().cpu())
                        train_terms = torch.stack([t for _, t in step_losses]).mean(0).cpu().numpy()
                    else:
                        train_loss, train_terms = np.nan, np.full(len(pseudo_names), np.nan)

                    val_loss, val_terms = np.nan, np.full(len(pseudo_names), np.nan)
                    if valid_data is not None and exhaustive_t_validation:
                        n_t = (self.schedule.timesteps if exhaustive_t_points <= 0
                               else min(int(exhaustive_t_points), self.schedule.timesteps))
                        ex_terms = self.eval_exhaustive_t(valid_data, n_t=n_t, seed=cfg.seed + epoch)
                        val_terms[: len(ex_terms)] = ex_terms
                        val_loss = float(np.mean(ex_terms))
                        if write_preds_to_dir:
                            first = next(self._batches(valid_data, host_rng, shuffle=False))[0]
                            self._write_val_preds(write_preds_to_dir, first, epoch, ex_terms)
                    elif valid_data is not None:
                        vlosses, vweights, first = [], [], None
                        for batch, w in self._batches(valid_data, host_rng, shuffle=False):
                            vlosses.append(self.eval_step(self.to_device(batch)))
                            vweights.append(w)
                            first = batch if first is None else first
                        if vlosses:
                            # Weighted by unmasked positions: the ragged tail must not count as a full batch
                            stacked = torch.stack(vlosses).cpu().numpy()
                            val_terms = np.average(stacked, axis=0, weights=vweights)
                            val_loss = float(np.mean(val_terms))
                            if write_preds_to_dir:
                                self._write_val_preds(write_preds_to_dir, first, epoch, stacked[0])

                    row = {"epoch": epoch, "step": self.step, "train_loss": train_loss, "val_loss": val_loss,
                           "lr": self.lr_schedule(self.step), "epoch_seconds": time.time() - t0}
                    for name, tv, vv in zip(pseudo_names, train_terms, val_terms):
                        row[f"train_loss_{name}"] = float(tv)
                        row[f"val_loss_{name}"] = float(vv)
                    rows.append(row)
                    if log_every and epoch % log_every == 0:
                        logging.info(f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} "
                                     f"({row['epoch_seconds']:.1f}s)")

                    if results_dir is not None:
                        self._csv_rows_flushed = append_metrics_csv(results_dir, rows, self._csv_rows_flushed)
                        valid_metric = val_loss if valid_data is not None else train_loss
                        for metric, best_by, heap in ((valid_metric, "valid", best_valid),
                                                      (train_loss, "train", best_train)):
                            save_topk(self.model, results_dir, train_args or {}, mean_offset, epoch, metric, best_by,
                                      heap)

                    if cfg.use_swa and epoch >= swa_start:
                        swa_count += 1
                        with torch.no_grad():
                            if swa_params is None:
                                swa_params = {k: torch.zeros_like(p) for k, p in self.model.named_parameters()}
                            for k, p in self.model.named_parameters():
                                swa_params[k].add_((p - swa_params[k]) / swa_count)

                    if results_dir is not None and save_state_every and (epoch + 1) % save_state_every == 0:
                        checkpoint.save_train_state(results_dir, self.model, self.optimizer, self.step, epoch)

                    if preempted["flag"]:
                        path = checkpoint.save_train_state(results_dir, self.model, self.optimizer, self.step, epoch)
                        logging.warning(f"Preemption checkpoint written to {path}; stopping")
                        break

                    # Early stopping on the validation loss (reference EarlyStopping)
                    if cfg.early_stop_patience and valid_data is not None:
                        if val_loss < best_val_loss:
                            best_val_loss, patience_count = val_loss, 0
                        else:
                            patience_count += 1
                        if patience_count >= cfg.early_stop_patience and epoch + 1 >= (cfg.min_epochs or 0):
                            logging.info(f"Early stopping at epoch {epoch}")
                            break
        finally:
            if previous_handler is not None:
                signal.signal(signal.SIGTERM, previous_handler)

        if cfg.use_swa and swa_params is not None and results_dir is not None:
            logging.info(f"Saving SWA weights averaged over {swa_count} epochs")
            state = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
            state.update({k: v.cpu() for k, v in swa_params.items()})
            model_io.save_model_dir(results_dir, self.model.config, state, train_args or {}, mean_offset=mean_offset,
                                    epoch=cfg.max_epochs, best_by="swa", keep_top_k=1)
        return rows

    def _write_val_preds(self, out_dir: str, batch: Batch, epoch: int, loss_terms) -> None:
        """Validation prediction dump (reference write_preds_to_dir,
        modelling.py:547-551, 606-614): known and predicted noise, mask and
        loss terms of one batch as <epoch>_preds.json."""
        os.makedirs(out_dir, exist_ok=True)
        dev = self.to_device(batch)
        b = dev["angles"].shape[0]
        t = torch.randint(0, self.schedule.timesteps, (b,), generator=self.generator, device=self.device)
        noise = sample_wrapped_noise(self.generator, tuple(dev["angles"].shape), self.is_angular)
        self.model.eval()
        with torch.inference_mode():
            _, pred, _, _ = self._predict(dev, t, noise)
        payload = {
            "known_noise": noise.cpu().numpy().tolist(),
            "predicted_noise": pred.cpu().numpy().tolist(),
            "attn_mask": np.asarray(batch["attn_mask"]).tolist(),
            "losses": [float(x) for x in loss_terms],
        }
        with open(os.path.join(out_dir, f"{epoch}_preds.json"), "w") as f:
            json.dump(payload, f)
