"""
The port's losses (foldingdiff_tpu_torch/losses.py) against the JAX
package's: values and gradients (torch autograd against jax.grad) of every
loss on the same seeded numpy inputs, plus the JAX docstrings' doctest
values. Float32 on both sides; values within 1e-6, gradients within
rtol 1e-5 / atol 1e-7 (other summation orders only).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu import losses as jax_losses
from foldingdiff_tpu_torch import losses

B, L = 4, 24


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    # input beyond [-pi, pi) (a raw network output), target wrapped
    x = rng.uniform(-3 * np.pi, 3 * np.pi, (B, L)).astype(np.float32)
    y = rng.uniform(-np.pi, np.pi, (B, L)).astype(np.float32)
    mask = (np.arange(L)[None, :] < rng.integers(L // 2, L + 1, (B, 1))).astype(np.float32)
    return x, y, mask


def _value_and_grad_torch(fn, x, *args):
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt, *[torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args])
    out.backward()
    return out.item(), xt.grad.numpy()


def _value_and_grad_jax(fn, x, *args):
    val, grad = jax.value_and_grad(lambda x_: fn(x_, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                                        for a in args]))(jnp.asarray(x))
    return float(val), np.asarray(grad)


# (name, port function, JAX function, extra positional args after input, target)
ANGULAR_CASES = {
    "radian_l1": (lambda x, y, m: losses.radian_l1_loss(x, y, mask=m),
                  lambda x, y, m: jax_losses.radian_l1_loss(x, y, mask=m)),
    "radian_smooth_l1": (lambda x, y, m: losses.radian_smooth_l1_loss(x, y, beta=math.pi / 10, mask=m),
                         lambda x, y, m: jax_losses.radian_smooth_l1_loss(x, y, beta=np.pi / 10, mask=m)),
    "radian_smooth_l1_circle": (
        lambda x, y, m: losses.radian_smooth_l1_loss(x, y, beta=math.pi / 10, circle_penalty=0.3, mask=m),
        lambda x, y, m: jax_losses.radian_smooth_l1_loss(x, y, beta=np.pi / 10, circle_penalty=0.3, mask=m)),
    "smooth_l1": (lambda x, y, m: losses.smooth_l1_loss(x, y, beta=1.0, mask=m),
                  lambda x, y, m: jax_losses.smooth_l1_loss(x, y, beta=1.0, mask=m)),
    "l1": (lambda x, y, m: losses.l1_loss(x, y, mask=m),
           lambda x, y, m: jax_losses.l1_loss(x, y, mask=m)),
}


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("name", sorted(ANGULAR_CASES))
def test_loss_value_and_gradient_match_jax(name, masked):
    x, y, mask = _inputs(seed=len(name))
    m = mask if masked else None
    ours_fn, ref_fn = ANGULAR_CASES[name]
    val, grad = _value_and_grad_torch(ours_fn, x, y, m)
    ref_val, ref_grad = _value_and_grad_jax(ref_fn, x, y, m)
    np.testing.assert_allclose(val, ref_val, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-5, atol=1e-7)


def test_doctest_values():
    assert round(losses.radian_l1_loss(torch.tensor(0.1), torch.tensor(2 * math.pi)).item(), 4) == 0.1
    assert round(losses.radian_l1_loss(torch.tensor(0.1), torch.tensor(2 * math.pi - 0.1)).item(), 4) == 0.2
    assert round(losses.radian_smooth_l1_loss(torch.tensor(-17.0466), torch.tensor(-1.3888), beta=0.1).item(), 4) \
        == 3.0414
    with pytest.raises(ValueError, match="beta must be positive"):
        losses.radian_smooth_l1_loss(torch.tensor(0.0), torch.tensor(0.0), beta=0.0)


def test_radian_l1_wraps_by_floored_modulo():
    """A negative input is wrapped by floored modulo (fmod would keep the
    sign and give 2 pi - 0.2 here)."""
    out = losses.radian_l1_loss(torch.tensor(-0.1), torch.tensor(0.1))
    assert abs(out.item() - 0.2) < 1e-6


def test_pair_mask_matches_jax():
    lengths = np.array([0, 1, 5, 7], dtype=np.int64)
    ours = losses._pair_mask(torch.tensor(lengths), 7).numpy()
    ref = np.asarray(jax_losses._pair_mask(jnp.asarray(lengths), 7))
    np.testing.assert_array_equal(ours, ref)
    assert ours[2].sum() == 10  # the 5 * 4 / 2 pairs of a 5-point item


@pytest.mark.parametrize("weights", [None, "scalar", "per_item"])
def test_pairwise_dist_loss_value_and_gradient_match_jax(weights):
    rng = np.random.default_rng(11)
    n = 16
    a = (rng.normal(size=(B, n, 3)) * 5).astype(np.float32)
    b = (a + rng.normal(size=(B, n, 3))).astype(np.float32)
    a[0, 3] = a[0, 2]  # a zero distance: the 1e-12 floor keeps its gradient finite
    lengths = np.array([n, 9, 2, 12], dtype=np.int64)
    w = {None: None, "scalar": 0.7, "per_item": rng.uniform(0.2, 1.0, B).astype(np.float32)}[weights]
    tw = torch.tensor(w) if isinstance(w, np.ndarray) else w
    jw = jnp.asarray(w) if isinstance(w, np.ndarray) else w
    val, grad = _value_and_grad_torch(lambda x: losses.pairwise_dist_loss(x, torch.tensor(b), torch.tensor(lengths),
                                                                          tw), a)
    ref_val, ref_grad = _value_and_grad_jax(lambda x: jax_losses.pairwise_dist_loss(x, jnp.asarray(b),
                                                                                    jnp.asarray(lengths), jw), a)
    assert np.all(np.isfinite(grad))
    np.testing.assert_allclose(val, ref_val, rtol=1e-6)
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-5, atol=1e-7)
