"""
Forward diffusion q(x_t | x_0) (counterpart of foldingdiff_tpu/diffusion/noise.py).

- noise ~ N(0, scale^2) per feature, angular channels wrapped to [-pi, pi)
  (reference datasets.py:793-797)
- x_t = sqrt(alpha_bar_t) x0 + sqrt(1 - alpha_bar_t) noise, angular channels
  wrapped again (reference datasets.py:861-871)

Random numbers come from an explicit torch.Generator on the output device;
they are not JAX's numbers for the same seed.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.ops.angles import wrap_angular_features


def _angular_mask(is_angular: Sequence[bool] | torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(is_angular, dtype=torch.bool, device=device)


def sample_wrapped_noise(
    generator: torch.Generator,
    shape: Tuple[int, ...],
    is_angular: Sequence[bool] | torch.Tensor,
    angular_scale: float = 1.0,
    nonangular_scale: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """
    Zero-centered Gaussian noise on the generator's device, variance-scaled
    per feature channel, with angular channels wrapped to [-pi, pi).
    shape[-1] must equal len(is_angular).
    """
    device = generator.device
    is_angular = _angular_mask(is_angular, device)
    noise = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    scale = torch.where(
        is_angular,
        torch.tensor(angular_scale, dtype=dtype, device=device),
        torch.tensor(nonangular_scale, dtype=dtype, device=device),
    )
    return wrap_angular_features(noise * scale, is_angular)


def q_sample(
    x0: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    schedule: DiffusionSchedule,
    is_angular: Sequence[bool] | torch.Tensor,
) -> torch.Tensor:
    """
    Diffuse x0 to timestep t given pre-sampled (already wrapped) noise.

    x0: (B, L, F); t: (B,) int on x0's device; noise: (B, L, F). Returns x_t
    with angular channels wrapped.
    """
    sqrt_ac = schedule.sqrt_alphas_cumprod[t][:, None, None]
    sqrt_omac = schedule.sqrt_one_minus_alphas_cumprod[t][:, None, None]
    noised = sqrt_ac * x0 + sqrt_omac * noise
    return wrap_angular_features(noised, _angular_mask(is_angular, x0.device))
