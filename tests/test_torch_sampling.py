"""
The port's DDPM sampler (diffusion/sampling.py) against the JAX package's:
one reverse step and a short chain given the same noise, and sample()'s
length sweep, chunking and mean-offset handling.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu.diffusion import sampling as jax_sampling
from foldingdiff_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from foldingdiff_tpu.models import io as jax_io
from foldingdiff_tpu_torch.diffusion import sampling
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.models import io as model_io

MINI_FIXTURE = os.path.join(os.path.dirname(__file__), "mini_model_for_testing", "results")
IS_ANGULAR = [True, True, True, True, True, False]


def _circular_diff(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


@pytest.mark.parametrize("t", [0, 1, 37, 99])
@pytest.mark.parametrize("noise_scale", [1.0, (0.5, 1.0, 1.5, 2.0, 1.0, 0.8)])
def test_p_sample_step_matches_jax(t, noise_scale):
    rng = np.random.default_rng(t)
    x = rng.uniform(-np.pi, np.pi, (2, 10, 6)).astype(np.float32)
    eps = rng.normal(size=x.shape).astype(np.float32)
    mask = np.ones((2, 10), dtype=np.float32)
    key = jax.random.PRNGKey(t)
    noise = np.array(jax.random.normal(key, x.shape, dtype=jnp.float32))  # what the JAX step draws
    ns = np.asarray(noise_scale, dtype=np.float32)

    ref = jax_sampling.p_sample_step(lambda *_: jnp.asarray(eps), jnp.asarray(x), jnp.asarray(t), key,
                                     jnp.asarray(mask), JaxSchedule.create("cosine", 100), IS_ANGULAR,
                                     jnp.asarray(ns))
    ours = sampling.p_sample_step(lambda *_: torch.from_numpy(eps), torch.from_numpy(x), t,
                                  torch.from_numpy(noise), torch.from_numpy(mask),
                                  DiffusionSchedule.create("cosine", 100), torch.tensor(IS_ANGULAR),
                                  torch.from_numpy(ns) if ns.ndim else float(ns))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_short_chain_matches_jax_given_its_noise():
    """Mini-fixture weights, linear T = 50 (the cosine schedule's clipped
    final betas amplify float32 drift), B = 3, L = 64: the port's loop is fed
    the per-step normals that JAX's p_sample_loop draws."""
    timesteps, b, l = 50, 3, 64
    jmodel, params, constants, _ = jax_io.from_dir(MINI_FIXTURE)
    jmodel = type(jmodel)(dataclasses.replace(jmodel.config, matmul_precision="highest"))
    model, _ = model_io.from_dir(MINI_FIXTURE)
    is_angular = [True] * 6

    rng = np.random.default_rng(7)
    x_t = rng.uniform(-np.pi, np.pi, (b, l, 6)).astype(np.float32)
    mask = (np.arange(l)[None, :] < np.array([[64], [50], [41]])).astype(np.float32)
    key = jax.random.PRNGKey(11)
    step_noise = np.stack([np.array(jax.random.normal(k, x_t.shape, dtype=jnp.float32))
                           for k in jax.random.split(key, timesteps)])

    def jax_model_fn(x, t, m):
        return jmodel.apply({"params": params, "constants": constants}, x, t, m, deterministic=True)

    ref = jax_sampling.p_sample_loop(jax_model_fn, jnp.asarray(x_t), key, jnp.asarray(mask),
                                     JaxSchedule.create("linear", timesteps), is_angular)
    ours = sampling.p_sample_loop(model, torch.from_numpy(x_t), torch.from_numpy(mask),
                                  DiffusionSchedule.create("linear", timesteps), is_angular,
                                  step_noise=torch.from_numpy(step_noise))
    assert _circular_diff(ours.numpy(), np.asarray(ref)).max() <= 1e-4


def test_p_sample_loop_needs_exactly_one_noise_source():
    schedule = DiffusionSchedule.create("linear", 3)
    x = torch.zeros(1, 4, 6)
    mask = torch.ones(1, 4)
    with pytest.raises(ValueError, match="exactly one"):
        sampling.p_sample_loop(lambda x, *_: x, x, mask, schedule, IS_ANGULAR)
    with pytest.raises(ValueError, match="step_noise must be"):
        sampling.p_sample_loop(lambda x, *_: x, x, mask, schedule, IS_ANGULAR, step_noise=torch.zeros(2, 1, 4, 6))


@pytest.fixture(scope="module")
def mini_model():
    model, _ = model_io.from_dir(MINI_FIXTURE)
    return model


def test_sample_lengths_order_range_and_offset(mini_model):
    schedule = DiffusionSchedule.create("cosine", 5)
    lengths = [40, 63, 17, 64, 33, 50, 18]
    kw = dict(is_angular=IS_ANGULAR, pad=64, lengths=lengths, batch_size=2, bucket_multiple=16, seed=3)
    offset = np.array([3.0, -3.0, 1.0, 0.5, -2.5, 10.0])
    raw = sampling.sample(mini_model, schedule, **kw)
    shifted = sampling.sample(mini_model, schedule, mean_offset=offset, **kw)
    assert [s.shape for s in raw] == [(n, 6) for n in lengths]
    for r, s in zip(raw, shifted):
        assert np.all(np.isfinite(s))
        assert s[:, :5].min() >= -np.pi and s[:, :5].max() < np.pi
        np.testing.assert_allclose(s[:, 5], r[:, 5] + offset[5], atol=1e-6)  # non-angular: plain shift
        assert _circular_diff(s[:, :5], r[:, :5] + offset[:5]).max() < 1e-6
    # Same seed, same chunks: sampling is reproducible
    again = sampling.sample(mini_model, schedule, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(raw, again))


def test_sample_sweep_and_chunks(mini_model):
    schedule = DiffusionSchedule.create("linear", 2)
    calls = []

    def sampler(attn_mask, seed, chunk_i):
        calls.append((tuple(attn_mask.shape), chunk_i))
        return torch.zeros(*attn_mask.shape, 6)

    out = sampling.sample(mini_model, schedule, is_angular=IS_ANGULAR, pad=64, n=2, sweep_lengths=(30, 36),
                          batch_size=4, bucket_multiple=32, sampler=sampler)
    assert [len(s) for s in out] == [30, 30, 31, 31, 32, 32, 33, 33, 34, 34, 35, 35]
    # Bucket 32 holds lengths 30-32 (6 items), bucket 64 holds 33-35 (6 items)
    assert calls == [((4, 32), 0), ((2, 32), 1), ((4, 64), 2), ((2, 64), 3)]
    with pytest.raises(ValueError, match="must be <"):
        sampling.sample(mini_model, schedule, is_angular=IS_ANGULAR, pad=64, sweep_lengths=(40, 40))
