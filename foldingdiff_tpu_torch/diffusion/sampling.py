"""
Reverse-diffusion (DDPM ancestral) sampling
(counterpart of foldingdiff_tpu/diffusion/sampling.py).

Reference behavior: foldingdiff/sampling.py:27-224.
- p_sample (DDPM Eq. 11): mean = 1/sqrt(a_t) (x - b_t eps / sqrt(1 - abar_t)),
  plus sqrt(posterior_variance_t) noise for t > 0
- per-feature angular wrap after every step
- x_T ~ wrapped N(0, scale) noise
- mean-offset un-shift and re-wrap at the end

The T-step chain is an eager Python loop under torch.inference_mode(); the
per-step schedule scalars come from the schedule's host copies, so the loop
never reads a value back from the device.

Seeds: sample() draws each chunk's x_T and per-step noise from its own
torch.Generator on the sampling device, seeded from (seed, chunk index)
through numpy's SeedSequence. The numbers differ from the JAX package's for
the same seed; only the distributions agree.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from foldingdiff_tpu.utils import modulo_with_wrapped_range
from foldingdiff_tpu_torch.diffusion.noise import sample_wrapped_noise
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.ops.angles import wrap_angular_features

ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def p_sample_step(
    model_fn: ModelFn,
    x: torch.Tensor,
    t: int,
    noise: Optional[torch.Tensor],
    attn_mask: torch.Tensor,
    schedule: DiffusionSchedule,
    is_angular: torch.Tensor,
    noise_scale: float | torch.Tensor = 1.0,
) -> torch.Tensor:
    """
    One reverse step at timestep t (a Python int). model_fn(x, t_vec, mask)
    -> eps. `noise` (like x) is the posterior noise, added only when t > 0 and
    then unused (None is allowed at t = 0). noise_scale is a scalar or an (F,)
    tensor: the per-feature sampling temperature on that noise (1.0 is
    reference DDPM). Angular channels (is_angular, (F,) bool) are wrapped.
    """
    host = schedule.host
    t_vec = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    eps_pred = model_fn(x, t_vec, attn_mask)
    sqrt_recip_alpha_t = float(host["sqrt_recip_alphas"][t])
    beta_t = float(host["betas"][t])
    sqrt_omac_t = float(host["sqrt_one_minus_alphas_cumprod"][t])
    x_next = sqrt_recip_alpha_t * (x - beta_t * eps_pred / sqrt_omac_t)
    if t > 0:
        sigma_t = float(host["sqrt_posterior_variance"][t])
        if torch.is_tensor(noise_scale):  # per feature, possibly made on the host
            noise_scale = noise_scale.to(device=x.device, dtype=x.dtype)
        x_next = x_next + sigma_t * (noise_scale * noise)
    return wrap_angular_features(x_next, is_angular)


def p_sample_loop(
    model_fn: ModelFn,
    noise: torch.Tensor,
    attn_mask: torch.Tensor,
    schedule: DiffusionSchedule,
    is_angular: Sequence[bool] | torch.Tensor,
    generator: Optional[torch.Generator] = None,
    step_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """
    Reverse chain T-1 .. 0 from x_T = `noise` (B, L, F). The posterior noise
    of step i (timestep T-1-i) is step_noise[i] when a (T, B, L, F) tensor is
    given, otherwise a fresh normal draw from `generator`. Returns x_0.
    """
    if (generator is None) == (step_noise is None):
        raise ValueError("give exactly one of generator and step_noise")
    timesteps = schedule.timesteps
    if step_noise is not None and step_noise.shape != (timesteps, *noise.shape):
        raise ValueError(f"step_noise must be {(timesteps, *noise.shape)}, got {tuple(step_noise.shape)}")
    is_angular = torch.as_tensor(is_angular, dtype=torch.bool, device=noise.device)
    x = noise
    with torch.inference_mode():
        for i, t in enumerate(range(timesteps - 1, -1, -1)):
            if t == 0:
                z = None
            elif step_noise is not None:
                z = step_noise[i]
            else:
                z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
            x = p_sample_step(model_fn, x, t, z, attn_mask, schedule, is_angular)
    return x


def chunk_generator(seed: int, chunk_i: int, device: torch.device | str) -> torch.Generator:
    """The generator of one sample() chunk: seeded with 63 bits of numpy's
    SeedSequence over (seed, chunk index)."""
    state = np.random.SeedSequence([seed, chunk_i]).generate_state(1, dtype=np.uint64)[0]
    generator = torch.Generator(device=device)
    generator.manual_seed(int(state) >> 1)
    return generator


def build_sampler(
    model: torch.nn.Module,
    schedule: DiffusionSchedule,
    is_angular: Sequence[bool],
    angular_variance: float = 1.0,
):
    """
    DDPM sampler closure over `model`, which runs on its own device:
    sampler(attn_mask, seed, chunk_i) -> x_0, with x_T and the step noise
    drawn from chunk_generator(seed, chunk_i).
    """
    n_ft = len(is_angular)

    def sampler(attn_mask: torch.Tensor, seed: int, chunk_i: int) -> torch.Tensor:
        generator = chunk_generator(seed, chunk_i, attn_mask.device)
        b, l = attn_mask.shape
        noise = sample_wrapped_noise(generator, (b, l, n_ft), is_angular, angular_variance)
        return p_sample_loop(model, noise, attn_mask, schedule, is_angular, generator=generator)

    return sampler


def sample(
    model: torch.nn.Module,
    schedule: DiffusionSchedule,
    *,
    is_angular: Sequence[bool],
    pad: int,
    n: int = 10,
    sweep_lengths: Optional[Tuple[int, int]] = (50, 128),
    lengths: Optional[Sequence[int]] = None,
    batch_size: int = 512,
    angular_variance: float = 1.0,
    mean_offset: Optional[np.ndarray] = None,
    seed: int = 0x1234,
    bucket_multiple: int = 64,
    sampler=None,
) -> List[np.ndarray]:
    """
    Batched DDPM sampling with a length sweep (reference sampling.sample,
    sampling.py:135-224) on the model's device. Returns one (length, F) array
    per requested structure, in request order, with the training mean offset
    re-applied and angular features re-wrapped.

    Lengths are grouped by padded bucket (a multiple of bucket_multiple, at
    most pad) before chunking by batch_size, so a short chunk runs at its
    small bucket. Chunk i is sampled from chunk_generator(seed, i).
    """
    if lengths is None:
        if sweep_lengths is None:
            raise ValueError("give lengths or sweep_lengths")
        sweep_min, sweep_max = sweep_lengths
        if not sweep_min < sweep_max:
            raise ValueError(f"Min length {sweep_min} must be < max {sweep_max}")
        lengths = [l for l in range(sweep_min, sweep_max) for _ in range(n)]
    lengths = list(lengths)
    logging.info(f"Sampling {len(lengths)} items in batches of {batch_size}")

    is_angular_arr = np.asarray(is_angular, dtype=bool)
    device = next(model.parameters()).device
    if sampler is None:
        sampler = build_sampler(model, schedule, list(is_angular_arr), angular_variance)

    def bucket_of(length: int) -> int:
        return min(pad, -(-length // bucket_multiple) * bucket_multiple)

    groups: dict = {}
    for i, length in enumerate(lengths):
        groups.setdefault(bucket_of(length), []).append(i)
    split_chunks: List[List[int]] = [
        g[i : i + batch_size]
        for _, g in sorted(groups.items())
        for i in range(0, len(g), batch_size)
    ]

    # Enqueue every chunk before reading any back, so the device never waits
    # on a host copy between chunks
    pending = []
    for chunk_i, idx_chunk in enumerate(split_chunks):
        this_lengths = [lengths[i] for i in idx_chunk]
        seq_len = bucket_of(max(this_lengths))
        attn_mask = torch.from_numpy(
            (np.arange(seq_len)[None, :] < np.asarray(this_lengths)[:, None]).astype(np.float32)
        ).to(device)
        pending.append((idx_chunk, this_lengths, sampler(attn_mask, seed, chunk_i)))

    results: dict = {}
    for idx_chunk, this_lengths, device_out in pending:
        sampled = device_out.cpu().numpy()
        for i, (orig_idx, l) in enumerate(zip(idx_chunk, this_lengths)):
            results[orig_idx] = sampled[i, :l, :]
    retval = [results[i] for i in range(len(lengths))]

    if mean_offset is not None:
        mean_offset = np.asarray(mean_offset)
        logging.info(f"Shifting predicted values by original offset: {mean_offset}")
        angular_idx = np.where(is_angular_arr)[0]
        shifted = []
        for s in retval:
            s = s + mean_offset
            s[..., angular_idx] = modulo_with_wrapped_range(s[..., angular_idx], -np.pi, np.pi)
            shifted.append(s)
        retval = shifted
    return retval
