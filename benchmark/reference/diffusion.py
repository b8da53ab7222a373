"""
The reverse chains' arithmetic in plain PyTorch and numpy: the cosine
variance schedule (Nichol & Dhariwal, as foldingdiff's beta_schedules.py,
betas clipped to [1e-4, 0.9999]), DDPM's ancestral step (foldingdiff
sampling.py p_sample), the wrap to [-pi, pi), and the noise of
one sampling chunk: the sampling protocol seeds chunk i of a job of seed s
with the top 63 bits of numpy's SeedSequence([s, i]) and draws x_T, then
each noisy step's noise, as standard normals shaped like the chunk.
"""
from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np
import torch


def wrap(x):
    """Into [-pi, pi) by floored modulo (tensors and numpy arrays)."""
    return ((x + math.pi) % (2 * math.pi)) - math.pi


def cosine_alphas_cumprod(timesteps: int, s: float = 8e-3) -> np.ndarray:
    """float64 alpha-bar of the clipped cosine betas."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    abar = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    abar = abar / abar[0]
    betas = np.clip(1 - abar[1:] / abar[:-1], 0.0001, 0.9999)
    return np.cumprod(1.0 - betas), betas


def ddpm_coefficients(timesteps: int) -> Tuple[np.ndarray, np.ndarray]:
    """(t, coefs) of the DDPM chain from T - 1 down to 0: per step float32
    1/sqrt(alpha_t), beta_t, 1/sqrt(1 - abar_t) and the posterior standard
    deviation, x_{t-1} = c0 (x_t - c1 c2 eps) + c3 z."""
    abar, betas = cosine_alphas_cumprod(timesteps)
    abar_prev = np.concatenate([[1.0], abar[:-1]])
    post_var = betas * (1.0 - abar_prev) / (1.0 - abar)
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    t = np.arange(timesteps - 1, -1, -1)
    coefs = np.stack([f32(1.0 / np.sqrt(1.0 - betas)), f32(betas),
                      np.float32(1.0) / f32(np.sqrt(1.0 - abar)), f32(np.sqrt(post_var))], axis=1)
    return t, coefs[t]


def chunk_seed(seed: int, chunk_i: int) -> int:
    return int(np.random.SeedSequence([seed, chunk_i]).generate_state(1, dtype=np.uint64)[0]) >> 1


def chunk_noise(seed: int, chunk_i: int, shape: Tuple[int, ...], variance: float, device) -> Iterator[torch.Tensor]:
    """The chunk's draws in order: x_T (scaled by `variance`, wrapped), then
    one standard normal per noisy step, for as long as the caller takes."""
    g = torch.Generator(device=device)
    g.manual_seed(chunk_seed(seed, chunk_i))
    yield wrap(torch.randn(shape, generator=g, device=device) * variance)
    while True:
        yield torch.randn(shape, generator=g, device=device)


def ddpm_step(x, eps, c, z):
    """x_{t-1} from x_t and eps with coefficients c (4,), noise z or None."""
    out = c[0] * (x - c[1] * eps * c[2])
    return wrap(out if z is None else out + c[3] * z)
