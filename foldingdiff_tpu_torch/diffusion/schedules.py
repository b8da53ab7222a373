"""
Variance (beta) schedules and derived alpha terms
(counterpart of foldingdiff_tpu/diffusion/schedules.py).

The schedules are computed in float64 numpy on the host, exactly as in the
JAX package, and stored as float32 tensors on a chosen device. The sampler
reads its per-step scalars from float32 host copies, so the reverse loop
never waits on the device for a schedule value.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

SCHEDULES = Literal["linear", "cosine", "quadratic"]


def cosine_beta_schedule(timesteps: int, s: float = 8e-3) -> np.ndarray:
    """Cosine schedule from Nichol & Dhariwal (https://arxiv.org/abs/2102.09672)."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0001, 0.9999)


def linear_beta_schedule(timesteps: int, beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)


def quadratic_beta_schedule(timesteps: int, beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    x = np.linspace(-6, 6, timesteps, dtype=np.float64)
    sigmoid = 1.0 / (1.0 + np.exp(-x))
    return sigmoid * (beta_end - beta_start) + beta_start


def get_variance_schedule(keyword: SCHEDULES, timesteps: int, **kwargs) -> np.ndarray:
    """Keyword dispatch matching reference beta_schedules.get_variance_schedule."""
    if keyword == "cosine":
        return cosine_beta_schedule(timesteps, **kwargs)
    elif keyword == "linear":
        return linear_beta_schedule(timesteps, **kwargs)
    elif keyword == "quadratic":
        return quadratic_beta_schedule(timesteps, **kwargs)
    raise ValueError(f"Unrecognized variance schedule: {keyword}")


def compute_alphas(betas: np.ndarray) -> dict:
    """All derived alpha terms, as in reference beta_schedules.compute_alphas."""
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    return {
        "betas": betas,
        "alphas": alphas,
        "alphas_cumprod": alphas_cumprod,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "posterior_variance": posterior_variance,
    }


ARRAY_NAMES = (
    "betas",
    "alphas",
    "alphas_cumprod",
    "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod",
    "posterior_variance",
    "sqrt_recip_alphas",
    "sqrt_posterior_variance",
)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """
    Precomputed schedule arrays, each (T,) float32 on `device`, plus `host`:
    the same arrays as float32 numpy, for per-step scalars read on the host.
    """

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    sqrt_posterior_variance: torch.Tensor
    host: dict
    timesteps: int
    schedule_name: str

    @classmethod
    def create(
        cls, keyword: SCHEDULES, timesteps: int, device: torch.device | str = "cpu", **kwargs
    ) -> "DiffusionSchedule":
        betas = get_variance_schedule(keyword, timesteps, **kwargs)
        terms = compute_alphas(betas)
        terms["sqrt_recip_alphas"] = 1.0 / np.sqrt(terms["alphas"])
        terms["sqrt_posterior_variance"] = np.sqrt(terms["posterior_variance"])
        host = {name: terms[name].astype(np.float32) for name in ARRAY_NAMES}
        return cls(
            **{name: torch.from_numpy(host[name]).to(device) for name in ARRAY_NAMES},
            host=host,
            timesteps=timesteps,
            schedule_name=keyword,
        )
