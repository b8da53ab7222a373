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

CUDA graphs (the JAX package's jitted step and fused_steps): on the card,
fit() runs each train step as one captured CUDA graph per batch shape, and
cfg.fused_steps = K same-shape steps as one (train_steps). The graph holds
the whole update: the draws of t and noise from the trainer's generator
(registered with the graph), the forward in train mode with its dropout,
the backward, the global-norm clip and AdamW, whose learning rate is a
device tensor that each replay fills from the schedule (capturable=True, as
it is for every trainer on the card: build_optimizer).
The batches are copied into the graph's static slots before each replay.
The steps draw in the order K train_step calls would, so a graph gives the
eager body's bits. The graphed step is the single-device one: under a mesh
the step stays eager, since the collectives over gloo (two ranks sharing one
card) cannot be captured, and so does a model under remat, whose checkpoints
read the generator's state on the host. cuda_graphs=False runs the eager
step on the card; eval_step, validation and the SWA average are eager
always.

Data parallelism (`mesh`, a parallel.mesh.Mesh; JAX's trainer.py:197-240,
412-471): every rank runs fit over the same host arrays, and a run over N
ranks computes what one device computes.
- Every rank draws the whole batch's t and noise (and the validation ones)
  from the same seeded generator, then takes its own rows of the batch,
  zero-padded to a multiple of the ranks, so the draws do not depend on the
  number of ranks. Dropout masks are each rank's own (seeded with cfg.seed
  plus the rank), so with dropout a DP step differs from one device's.
- Each rank's loss divides by the global batch's counts of unmasked
  positions and valid pairs (summed over the ranks): the ranks' losses sum
  to the global masked mean, where averaging each rank's own mean would
  weight the ranks' rows wrongly whenever their counts differ.
- The gradients are summed over the ranks; the L1 penalty's gradient, the
  global-norm clip and AdamW then run on the summed gradients and the
  replicated parameters, once, as on one device.
- The step losses and the validation terms are reduced over the ranks, so
  metrics.csv equals one device's. Only rank 0 writes files; resume reads
  the train state on rank 0 and broadcasts it.
A (data, model) parallel.tp.Mesh2D works the same way over its data axis
(parallel/tp.py).
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
from foldingdiff_tpu_torch.diffusion.noise import draw_t_and_noise, q_sample, sample_wrapped_noise
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.geometry import nerf
from foldingdiff_tpu_torch.graphs import StepGraph
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.bert import BertForDiffusion
from foldingdiff_tpu_torch.parallel.mesh import Mesh, broadcast_object, replicate, shard_batch
from foldingdiff_tpu_torch.parallel.multihost import is_primary
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
    # K same-shape train steps as one device execution: on the card one CUDA
    # graph of K steps (JAX's lax.scan over K batches, the same draws as K
    # single steps); a remainder of fewer than K batches, and the ragged
    # tail, run through the single-step graph of their shape. 1 = one graph
    # per step. The eager step (the CPU, a mesh) runs the steps one by one.
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
    gradients first (clip_by_global_norm_). On the card the update is
    capturable, graphed or not, so that every trainer there (graphed, eager,
    under a mesh or remat) runs one arithmetic: its learning rate is a
    float32 tensor, which optimizer_step fills, its step counts are float32
    on the card and its bias corrections float32, as optax's. On the CPU,
    where capturable AdamW does not run, the learning rate is a float and the
    bias corrections float64."""
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    if device.type != "cuda":
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.l2_norm)
    return torch.optim.AdamW(params, lr=torch.tensor(cfg.lr, dtype=torch.float32, device=device),
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.l2_norm, capturable=True)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         sum_squares: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient times max / ||g||
    when the global norm ||g|| >= max, untouched below it (torch's
    clip_grad_norm_ uses max / (||g|| + 1e-6) instead). sum_squares sums the
    gradients' squared norms over the whole model when they are shards of it.
    Returns ||g||; the host never waits for it."""
    norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
    g_norm = torch.linalg.vector_norm(norms) if sum_squares is None else sum_squares(norms.square()).sqrt()
    scale = (max_norm / g_norm).clamp(max=1.0)
    for g in grads:
        g.mul_(scale)
    return g_norm


def optimizer_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                   gradient_clip: float, lr: float | torch.Tensor, mesh: Optional[Mesh] = None,
                   l1_norm: float = 0.0) -> None:
    """Backward from `loss`, then the gradients summed over the mesh (each
    rank's loss is its share of the global loss), the L1 penalty's gradient
    (l1_norm times d|p|/dp, which is +1 at p = 0 as jnp.abs's), the
    global-norm clip and the AdamW step at learning rate `lr`: one update of
    either trainer. `lr` is a float or, for a capturable optimizer, a
    0-dim device tensor (a graph's slot); a capturable optimizer's own lr
    tensor takes its value in place. The backward pass runs in the model's
    matmul_scope, as its forward did: JAX's transposes keep each dot's
    precision, and cuBLAS picks its kernels at the call (or the capture).
    The loss's own backward runs in it as well: the port's losses have no
    GEMM."""
    optimizer.zero_grad(set_to_none=True)
    with model.matmul_scope():
        loss.backward()
    with torch.profiler.record_function("optimizer"):
        named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
        if mesh is not None:
            mesh.reduce_gradients(named)
        if l1_norm:
            with torch.no_grad():
                for _, p in named:
                    p.grad.add_(torch.where(p >= 0, l1_norm, -l1_norm))
        if gradient_clip:
            names = [n for n, _ in named]
            clip_by_global_norm_([p.grad for _, p in named], gradient_clip,
                                 None if mesh is None else lambda sq: mesh.sum_over_shards(sq, names))
        for group in optimizer.param_groups:
            if not torch.is_tensor(group["lr"]):
                group["lr"] = lr
            elif torch.is_tensor(lr):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        optimizer.step()


@contextlib.contextmanager
def dropout_rng(device: torch.device, seed: int, mesh: Optional[Mesh] = None):
    """The device's default generator (dropout's) seeded with `seed` while
    the block runs, its state restored after; under a mesh with seed plus
    this rank's index on it, so that each rank draws its own masks."""
    devices = [device.index or 0] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed + (mesh.rank if mesh is not None else 0))
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
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-feature masked losses, stacked (F,), each dividing by `count`
    (default: the mask's). Angular features take the wrapped loss with
    beta = pi/10 (modelling.py:228-233)."""
    terms = []
    for i, ang in enumerate(is_angular):
        p, t = pred[..., i], target[..., i]
        if loss_name == "smooth_l1":
            terms.append(loss_lib.radian_smooth_l1_loss(p, t, beta=math.pi / 10, circle_penalty=circle_reg, mask=mask,
                                                        count=count)
                         if ang else loss_lib.smooth_l1_loss(p, t, beta=1.0, mask=mask, count=count))
        elif loss_name == "l1":
            terms.append(loss_lib.radian_l1_loss(p, t, mask=mask, count=count) if ang
                         else loss_lib.l1_loss(p, t, mask=mask, count=count))
        else:
            raise ValueError(f"Unknown loss {loss_name}")
    return torch.stack(terms)


Batch = Dict[str, np.ndarray]
BATCH_KEYS = ("angles", "attn_mask", "lengths")


class Trainer:
    """
    Train and validation steps over stacked host arrays: dicts with "angles"
    (N, pad, F), "attn_mask" (N, pad) and "lengths" (N,), as
    AngleDataset.to_arrays() gives them. Under a mesh every rank passes the
    same global batches and each step runs this rank's rows of them (see the
    module docstring).
    """

    def __init__(
        self, model: BertForDiffusion, schedule: DiffusionSchedule, train_cfg: TrainConfig, steps_per_epoch: int,
        mesh: Optional[Mesh] = None, cuda_graphs: bool = True,
    ) -> None:
        self.device = schedule.betas.device
        devices = {p.device for p in model.parameters()}
        if devices != {self.device}:
            raise ValueError(f"model parameters on {devices}, schedule on {self.device}")
        self.model = model
        self.schedule = schedule
        self.cfg = train_cfg
        self.mesh = mesh
        if mesh is not None:
            replicate(mesh, model)  # rank 0's weights on every rank
        self.primary = is_primary()  # the process that writes files
        self.lr_schedule = make_lr_schedule(train_cfg, steps_per_epoch)
        # fit() steps as CUDA graphs: on the card, on one device, without remat (module docstring)
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda" and mesh is None and not model.config.remat
        self.optimizer = build_optimizer(train_cfg, model.parameters())
        self.step = 0  # global step: the optimizer updates made so far
        self.is_angular = tuple(model.config.ft_is_angular)
        self.ft_names = tuple(model.config.ft_names)
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        # made once on the device, so that no step copies them from the host (a graph cannot)
        self._angular_mask = torch.tensor(self.is_angular, dtype=torch.bool, device=self.device)
        self._nerf_init = torch.as_tensor(nerf.INIT_COORDS, dtype=torch.float32, device=self.device)
        self._graphs: Dict[tuple, Tuple[List[Dict[str, torch.Tensor]], torch.Tensor, StepGraph]] = {}
        self._graph_pool = None
        self._csv_rows_flushed = 0

    @property
    def use_pdist(self) -> bool:
        p = self.cfg.use_pdist_loss
        return (p[0] if isinstance(p, (list, tuple)) else p) > 0

    def to_device(self, batch: Batch, keys: Sequence[str] = ("angles", "attn_mask", "lengths")
                  ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device) for k in keys}

    # -- the mesh ------------------------------------------------------------
    def _local(self, batch: Dict[str, torch.Tensor], *tensors: torch.Tensor):
        """(batch, *tensors) as this rank's rows: all of them without a mesh."""
        if self.mesh is None:
            return (batch, *tensors)
        parts = shard_batch(self.mesh, *batch.values(), *tensors)
        parts = parts if isinstance(parts, tuple) else (parts,)
        return (dict(zip(batch, parts[: len(batch)])), *parts[len(batch):])

    def _count(self, count: torch.Tensor) -> Optional[torch.Tensor]:
        """The global batch's count (of unmasked positions or valid pairs)
        that a rank's losses divide by; None (their own) without a mesh."""
        return None if self.mesh is None else self.mesh.all_reduce(count.detach().clone())

    def _global(self, terms: torch.Tensor) -> torch.Tensor:
        """Loss terms summed over the ranks: the global batch's."""
        return terms if self.mesh is None else self.mesh.all_reduce(terms.clone())

    # -- core loss ----------------------------------------------------------
    def _draw(self, batch, t=None, noise=None):
        """(t, noise) for the whole device batch: drawn from the trainer's
        generator unless the caller gives both."""
        if (t is None) != (noise is None):
            raise ValueError("give both t and noise, or neither")
        if t is None:
            x0 = batch["angles"]
            t, noise = draw_t_and_noise(self.generator, tuple(x0.shape), self.schedule, self._angular_mask,
                                        self.cfg.angular_variance, self.cfg.nonangular_variance, x0.dtype)
        return t, noise

    def _predict(self, batch, t, noise):
        """(corrupted, pred) of a device batch, given its t and noise."""
        corrupted = q_sample(batch["angles"], t, noise, self.schedule, self._angular_mask)
        return corrupted, self.model(corrupted, t, batch["attn_mask"])

    def _feature_terms(self, pred, target, mask, is_angular=None) -> torch.Tensor:
        return _per_feature_losses(pred, target, mask, self.is_angular if is_angular is None else is_angular,
                                   self.cfg.loss, self.cfg.circle_reg, self._count(mask.sum()))

    def _loss_terms(self, batch, t=None, noise=None) -> torch.Tensor:
        """(F,) per-feature losses of a device batch, plus the pdist term when
        it is on, in the model's current mode; t and noise drawn for the whole
        batch unless the caller gives both. Under a mesh the batch, t and
        noise are the global batch's and the terms this rank's share of its
        losses: summed over the ranks they are the global batch's."""
        t, noise = self._draw(batch, t, noise)
        batch, t, noise = self._local(batch, t, noise)
        corrupted, pred = self._predict(batch, t, noise)
        terms = self._feature_terms(pred, noise, batch["attn_mask"])
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
                init_coords=self._nerf_init,
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
        lengths = batch["lengths"]
        return loss_lib.pairwise_dist_loss(denoised_ca, inferred_ca, lengths=lengths, weights=coef,
                                           count=self._count(loss_lib.pair_count(lengths, denoised_ca.shape[1])))

    def l1_penalty(self) -> torch.Tensor:
        """The sum of |p| over the parameters (the time embedding's W buffer
        is not one), over the whole model when they are tensor-parallel
        shards. Its gradient at p = 0 is +1, as jnp.abs's is."""
        named = list(self.model.named_parameters())
        sums = torch.stack([torch.where(p >= 0, p, -p).sum() for _, p in named])
        return sums.sum() if self.mesh is None else self.mesh.sum_over_shards(sums, [n for n, _ in named])

    def _update(self, loss: torch.Tensor, l1_norm: float = 0.0) -> None:
        """One clipped AdamW update from `loss` at the schedule's learning rate."""
        # optax reads the count before its increment
        optimizer_step(self.model, self.optimizer, loss, self.cfg.gradient_clip, self.lr_schedule(self.step),
                       self.mesh, l1_norm)
        self.step += 1

    def train_step(self, batch, t=None, noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update from a device batch (the global batch under a mesh):
        (loss, per-feature terms) of the global batch, both detached on the
        device. The loss includes the L1 penalty, as JAX's; its gradient is
        added to the summed gradients, once. Eager: fit() runs train_steps
        on the card."""
        # optax reads the count before its increment
        out = self._step_terms(batch, self.lr_schedule(self.step), t, noise)
        self.step += 1
        return out

    def _step_terms(self, batch, lr: float | torch.Tensor, t=None, noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """train_step's update at learning rate `lr`, leaving self.step to the
        caller: the body of the step graphs, which must not change host
        state."""
        self.model.train()
        terms = self._loss_terms(batch, t, noise)
        l1 = self.cfg.l1_norm
        if l1 > 0:
            with torch.no_grad():  # at the parameters before the update
                penalty = l1 * self.l1_penalty()
        optimizer_step(self.model, self.optimizer, terms.mean(), self.cfg.gradient_clip, lr, self.mesh, l1)
        terms = self._global(terms.detach())
        avg = terms.mean()
        return (avg + penalty if l1 > 0 else avg), terms

    # -- the step as CUDA graphs ----------------------------------------------
    def train_steps(self, batches: Sequence[Batch]) -> torch.Tensor:
        """len(batches) = K updates from host batches of one shape, as one
        replay of the CUDA graph of K steps of that shape (JAX's
        _multi_train_step for K > 1): a fresh (K, 1 + F') device tensor, row
        k step k's loss and per-feature terms as train_step returns them. The
        graph is captured at the (K, shape)'s first use, whose steps run
        eagerly (graphs.StepGraph). Raises unless self.cuda_graphs."""
        if not self.cuda_graphs:
            raise RuntimeError("train_steps runs CUDA graphs: a trainer on the card, on one device, without remat")
        k = len(batches)
        key = (k, tuple(np.shape(batches[0]["angles"])))
        if key not in self._graphs:
            self._graphs[key] = self._capture_steps(k, batches[0])
        slots, lrs, graph = self._graphs[key]
        for slot, batch in zip(slots, batches):
            for name, dst in slot.items():
                dst.copy_(torch.from_numpy(np.ascontiguousarray(batch[name])).pin_memory(), non_blocking=True)
        for i in range(k):
            lrs[i].fill_(self.lr_schedule(self.step + i))
        out = graph()
        self.step += k
        return out.clone()

    def _capture_steps(self, k: int, like: Batch):
        """(batch slots, learning-rate slots, StepGraph) of K steps of like's shape."""
        slots = [{name: torch.empty(np.shape(like[name]), dtype=torch.from_numpy(np.asarray(like[name])).dtype,
                                    device=self.device) for name in BATCH_KEYS} for _ in range(k)]
        lrs = torch.zeros(k, dtype=torch.float32, device=self.device)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = StepGraph(self._steps_body(slots, lrs), self.device, generators=[self.generator],
                          pool=self._graph_pool)
        return slots, lrs, graph

    def _steps_body(self, slots: Sequence[Dict[str, torch.Tensor]], lrs: torch.Tensor) -> Callable[[], torch.Tensor]:
        """The body of a graph of len(slots) steps: step k from device batch
        slots[k] at learning rate lrs[k], in the order of as many train_step
        calls; returns (K, 1 + F') of each step's loss and terms. A plain
        function, so it also runs eagerly, on any device."""
        def body() -> torch.Tensor:
            rows = [self._step_terms(slot, lrs[i]) for i, slot in enumerate(slots)]
            return torch.stack([torch.cat([loss[None], terms]) for loss, terms in rows])

        return body

    def _graphed_epoch(self, batches: Iterator[Tuple[Batch, float]]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """An epoch's updates through train_steps: full groups of
        cfg.fused_steps consecutive same-shape batches as one replay each,
        the rest one by one; (loss, terms) per step, as train_step's."""
        k = max(int(self.cfg.fused_steps), 1)
        rows: List[torch.Tensor] = []
        group: List[Batch] = []
        for batch, _ in batches:
            if group and np.shape(batch["angles"]) != np.shape(group[0]["angles"]):
                rows.extend(self.train_steps([b]) for b in group)
                group = []
            group.append(batch)
            if len(group) == k:
                rows.append(self.train_steps(group))
                group = []
        rows.extend(self.train_steps([b]) for b in group)
        return [(r[0], r[1:]) for out in rows for r in out]

    # -- pre-corrupted path (debug noisers) ----------------------------------
    def _loss_terms_precorrupted(self, batch) -> torch.Tensor:
        """(F,) per-feature losses of a host-noised device batch, which
        carries "corrupted", "t", "known_noise" and "attn_mask" (the
        reference's dataset-noising contract, datasets.py:873-879), in the
        model's current mode; this rank's share of them under a mesh."""
        (batch,) = self._local(batch)
        pred = self.model(batch["corrupted"], batch["t"].reshape(-1), batch["attn_mask"])
        return self._feature_terms(pred, batch["known_noise"], batch["attn_mask"], self.is_angular[: pred.shape[-1]])

    def train_step_precorrupted(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update from a host-noised device batch (the debug noisers'):
        (loss, per-feature terms), both detached on the device. The loss is
        the mean of the terms, without the L1 penalty, as JAX's."""
        self.model.train()
        terms = self._loss_terms_precorrupted(batch)
        self._update(terms.mean())
        terms = self._global(terms.detach())
        return terms.mean(), terms

    def eval_step(self, batch, t=None, noise=None) -> torch.Tensor:
        """Loss terms of a device batch (the global batch's under a mesh) in
        eval mode, without gradients."""
        self.model.eval()
        with torch.inference_mode():
            return self._global(self._loss_terms(batch, t, noise))

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
                    batch, t_vec, noise = self._local(batch, torch.full((b,), int(t), device=self.device), noise)
                    _, pred = self._predict(batch, t_vec, noise)
                    all_terms.append(self._global(self._feature_terms(pred, noise, batch["attn_mask"])))
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
            batch = {k: data[k][sel] for k in BATCH_KEYS}
            yield batch, float(np.sum(batch["attn_mask"]))

    def _restore(self, results_dir: str) -> int:
        """Restore the newest train state under results_dir, if there is one,
        and return the epoch to continue at. Under a mesh rank 0 reads it and
        broadcasts it, so a rank that cannot see the file (another host's
        disk) continues at the same epoch with the same state."""
        payload = None
        if self.mesh is None or self.primary:
            path = checkpoint.latest_train_state(results_dir)
            payload = None if path is None else checkpoint.read_train_state(path)
        if self.mesh is not None:
            payload = broadcast_object(self.mesh, payload)
        if payload is None:
            return 0
        self.step, start_epoch = checkpoint.apply_train_state(payload, self.model, self.optimizer)
        self._settle_optimizer()
        logging.info(f"Resumed train state at epoch {start_epoch}")
        return start_epoch

    def _settle_optimizer(self) -> None:
        """After a train state's load, the optimizer as build_optimizer makes
        it for this trainer's device, whichever device saved the state: on
        the card capturable, with its lr tensor and step counts there; on the
        CPU a float lr and host step counts. Graphs captured before the load
        held the old state's tensors and are dropped."""
        on_card = self.device.type == "cuda"
        lr = next((g["lr"] for g in self.optimizer.param_groups if torch.is_tensor(g["lr"])), None)
        for group in self.optimizer.param_groups:
            group["capturable"] = on_card
            if on_card:
                if lr is None or lr.device != self.device:
                    lr = torch.tensor(float(group["lr"]), dtype=torch.float32, device=self.device)
                group["lr"] = lr
            else:
                group["lr"] = float(group["lr"])
        step_device = self.device if on_card else torch.device("cpu")
        for state in self.optimizer.state.values():
            if "step" in state:
                state["step"] = state["step"].to(device=step_device, dtype=torch.float32)
        self._graphs.clear()

    def _any_rank(self, flag: bool) -> bool:
        """Whether any rank raised the flag (the flag itself without a mesh)."""
        if self.mesh is None:
            return flag
        return bool(self.mesh.all_reduce(torch.tensor([float(flag)], device=self.device)).item() > 0)

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
        CSV and the top-5 model directories there (rank 0 only, under a
        mesh); with resume it continues from the newest train state there."""
        cfg = self.cfg
        self.generator.manual_seed(cfg.seed)
        host_rng = np.random.default_rng(cfg.seed)
        rows: List[Dict[str, float]] = []
        writes = self.primary and results_dir is not None

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

        start_epoch = self._restore(results_dir) if resume and results_dir is not None else 0
        # metrics.csv is appended to per epoch: a resumed run continues the
        # file, a fresh run into a used results_dir truncates it
        self._csv_rows_flushed = 0
        if writes and start_epoch == 0:
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
            with dropout_rng(self.device, cfg.seed, self.mesh):
                for epoch in range(start_epoch, cfg.max_epochs):
                    t0 = time.time()
                    if train_data_refresh is not None:  # per-epoch randomcrop re-crop
                        train_data = train_data_refresh(epoch)
                    # Losses stay on the device until the epoch ends: one host sync per epoch
                    batches = self._batches(train_data, host_rng, shuffle=True)
                    if self.cuda_graphs:
                        step_losses = self._graphed_epoch(batches)
                    else:
                        step_losses = [self.train_step(self.to_device(batch)) for batch, _ in batches]
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

                    if writes:
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

                    if writes and save_state_every and (epoch + 1) % save_state_every == 0:
                        checkpoint.save_train_state(results_dir, self.model, self.optimizer, self.step, epoch)

                    if results_dir is not None and self._any_rank(preempted["flag"]):
                        if writes:
                            path = checkpoint.save_train_state(results_dir, self.model, self.optimizer, self.step,
                                                               epoch)
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

        if cfg.use_swa and swa_params is not None and writes:
            logging.info(f"Saving SWA weights averaged over {swa_count} epochs")
            state = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
            state.update({k: v.cpu() for k, v in swa_params.items()})
            model_io.save_model_dir(results_dir, self.model.config, state, train_args or {}, mean_offset=mean_offset,
                                    epoch=cfg.max_epochs, best_by="swa", keep_top_k=1)
        return rows

    def _write_val_preds(self, out_dir: str, batch: Batch, epoch: int, loss_terms) -> None:
        """Validation prediction dump (reference write_preds_to_dir,
        modelling.py:547-551, 606-614): known and predicted noise, mask and
        loss terms of one batch as <epoch>_preds.json. Every rank draws its t
        and noise, so the generators stay together; rank 0 writes."""
        dev = self.to_device(batch)
        b = dev["angles"].shape[0]
        t = torch.randint(0, self.schedule.timesteps, (b,), generator=self.generator, device=self.device)
        noise = sample_wrapped_noise(self.generator, tuple(dev["angles"].shape), self.is_angular)
        if not self.primary:
            return
        os.makedirs(out_dir, exist_ok=True)
        self.model.eval()
        with torch.inference_mode():
            _, pred = self._predict(dev, t, noise)
        payload = {
            "known_noise": noise.cpu().numpy().tolist(),
            "predicted_noise": pred.cpu().numpy().tolist(),
            "attn_mask": np.asarray(batch["attn_mask"]).tolist(),
            "losses": [float(x) for x in loss_terms],
        }
        with open(os.path.join(out_dir, f"{epoch}_preds.json"), "w") as f:
            json.dump(payload, f)
