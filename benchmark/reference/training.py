"""
One training update of foldingdiff's denoiser in plain PyTorch
(modelling.py:553-706 and bin/train.py): t ~ U[0, T) and wrapped N(0, 1)
noise per item from a seeded generator, x_t = wrap(sqrt(abar_t) x0 +
sqrt(1 - abar_t) noise), the predicted noise in train mode, the
per-feature wrapped smooth-L1 (beta = pi/10) over unmasked positions
meaned over features, then the gradients clipped by their global norm
(times max / ||g|| when ||g|| >= max) and AdamW (0.9, 0.999, 1e-8) at the LinearWarmup rate.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import denoiser
from benchmark.reference.diffusion import cosine_alphas_cumprod, wrap

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def linear_warmup_lr(lr: float, max_epochs: int, steps_per_epoch: int, step: int) -> float:
    """foldingdiff's LinearWarmup, stepped per epoch, 10% of the epochs
    warming up, then a linear decay; float32 as the published schedule."""
    f32 = np.float32
    warm = int(max_epochs * 0.1)
    epoch = step // max(steps_per_epoch, 1)
    if epoch < warm:
        factor = min(f32(epoch) / f32(warm), f32(1.0))
    else:
        factor = min(max((f32(max_epochs) - f32(epoch)) / f32(max(max_epochs - warm, 1)), f32(0.0)), f32(1.0))
    return float(f32(lr) * factor)


def huber(d: torch.Tensor, beta: float) -> torch.Tensor:
    a = d.abs()
    return torch.where(a < beta, 0.5 * d ** 2 / beta, a - 0.5 * beta)


def loss_terms(params, config, batch, t, noise, sqrt_ac, sqrt_omac) -> torch.Tensor:
    """(F,) per-feature losses of a
    device batch at the given t and noise, dropout drawn as the model runs."""
    x0, mask = batch["angles"], batch["attn_mask"]
    x_t = wrap(sqrt_ac[t][:, None, None] * x0 + sqrt_omac[t][:, None, None] * noise)
    pred = denoiser.forward(params, config, x_t, t, mask, train=True)
    m = mask.to(pred.dtype)
    count = m.sum().clamp_min(1.0)
    terms = [(huber(wrap(noise[..., i] - pred[..., i]), math.pi / 10) * m).sum() / count
             for i in range(pred.shape[-1])]
    return torch.stack(terms)


class Reference:
    """The reference's parameters, AdamW state and generator, stepped on
    the same batches as the program."""

    def __init__(self, params: Dict[str, torch.Tensor], config: dict, seed: int, steps_per_epoch: int, step0: int):
        self.config = config
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()
                       if k != "time_embed.W"}
        self.buffers = {"time_embed.W": params["time_embed.W"].detach().clone()}
        device = params["time_embed.W"].device
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        abar = cosine_alphas_cumprod(config["timesteps"])[0]
        self.sqrt_ac, self.sqrt_omac = (torch.from_numpy(np.sqrt(a).astype(np.float32)).to(device)
                                        for a in (abar, 1.0 - abar))
        self.steps_per_epoch, self.step, self.count = steps_per_epoch, step0, 0

    def update(self, batch: Dict[str, torch.Tensor]) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One update: (loss, the clipped gradient of each parameter)."""
        x0 = batch["angles"]
        t = torch.randint(0, self.config["timesteps"], (x0.shape[0],), generator=self.generator, device=x0.device)
        noise = wrap(torch.randn(x0.shape, generator=self.generator, device=x0.device) * 1.0)
        terms = loss_terms({**self.params, **self.buffers}, self.config, batch, t, noise, self.sqrt_ac,
                           self.sqrt_omac)
        loss = terms.mean()
        self.last_terms = terms.detach().tolist()
        grads = dict(zip(self.params, torch.autograd.grad(loss, list(self.params.values()))))
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        scale = (self.config["gradient_clip"] / norm).clamp(max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
        lr = linear_warmup_lr(self.config["lr"], self.config["max_epochs"], self.steps_per_epoch, self.step)
        self.count += 1
        b1, b2 = BETAS
        with torch.no_grad():
            for k, p in self.params.items():
                self.m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                m_hat = self.m[k] / (1 - b1 ** self.count)
                v_hat = self.v[k] / (1 - b2 ** self.count)
                p.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
        self.step += 1
        return float(loss.detach()), grads


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float], keep: List[str]) -> Dict[str, float]:
    """|program norm - reference norm| of each kept leaf, against the larger
    of its reference norm and the median leaf's."""
    median = float(np.median([reference[k] for k in keep]))
    return {k: abs(program[k] - reference[k]) / max(reference[k], median) for k in keep}


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float], keep: List[str]) -> Tuple[float, str]:
    """(gap, leaf) of the leaf with the largest gap."""
    gaps = leaf_gaps(program, reference, keep)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def median_leaf_gap(program: Dict[str, float], reference: Dict[str, float], keep: List[str]) -> float:
    return float(np.median(list(leaf_gaps(program, reference, keep).values())))
