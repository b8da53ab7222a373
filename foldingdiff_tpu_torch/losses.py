"""
Wrapped-angle regression losses and the pairwise-distance loss, masked
(counterpart of foldingdiff_tpu/losses.py; reference foldingdiff/losses.py):
- radian_l1_loss: mean |wrap(target - input)|             (losses.py:12-26)
- radian_smooth_l1_loss: huber on wrap(target - input),   (losses.py:29-63)
  optional circle penalty on trunc(|input| / pi)
- pairwise_dist_loss: MSE over all intra-length pairwise CA distances,
  meaned over the valid pairs of the batch                (losses.py:66-149)

As in the JAX package, the pairwise loss computes the full (B, N, N)
distance matrix and masks the pairs i < j < length, in place of the
reference's per-item pdist loop: each valid pair counts once, so the mean is
the same. Every wrap is floored modulo (`%`), never torch.fmod.

Each masked loss takes `count`, the count of unmasked positions (or valid
pairs) to divide by, by default its own mask's: a data-parallel rank passes
the global batch's, so that its loss is its share of the global batch's
masked mean and the ranks' losses sum to it, as JAX's mean over a sharded
batch is.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from foldingdiff_tpu_torch.ops.angles import wrap_angles


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor], count: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    if mask is None:
        return values.mean()
    mask = mask.to(values.dtype)
    return (values * mask).sum() / (mask.sum() if count is None else count).clamp_min(1.0)


def radian_l1_loss(input: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """
    Mean absolute wrapped angular difference.

    >>> round(radian_l1_loss(torch.tensor(0.1), torch.tensor(2 * math.pi)).item(), 4)
    0.1
    >>> round(radian_l1_loss(torch.tensor(0.1), torch.tensor(2 * math.pi - 0.1)).item(), 4)
    0.2
    """
    d = wrap_angles(target % (2 * math.pi) - input % (2 * math.pi))
    return _masked_mean(d.abs(), mask, count)


def _huber(d: torch.Tensor, beta: float) -> torch.Tensor:
    abs_d = d.abs()
    return torch.where(abs_d < beta, 0.5 * d**2 / beta, abs_d - 0.5 * beta)


def radian_smooth_l1_loss(
    input: torch.Tensor,
    target: torch.Tensor,
    beta: float = 1.0,
    circle_penalty: float = 0.0,
    mask: Optional[torch.Tensor] = None,
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """
    Smooth-L1 (huber) on the wrapped angular difference:
    0.5 d^2 / beta if |d| < beta else |d| - 0.5 beta, plus circle_penalty
    times the masked mean of trunc(|input| / pi).

    >>> round(radian_smooth_l1_loss(torch.tensor(-17.0466), torch.tensor(-1.3888), beta=0.1).item(), 4)
    3.0414
    """
    if beta <= 0:
        raise ValueError(f"beta must be positive, got {beta}")
    retval = _masked_mean(_huber(wrap_angles(target - input), beta), mask, count)
    if circle_penalty > 0:
        retval = retval + circle_penalty * _masked_mean(torch.trunc(input.abs() / math.pi), mask, count)
    return retval


def smooth_l1_loss(
    input: torch.Tensor, target: torch.Tensor, beta: float = 1.0, mask: Optional[torch.Tensor] = None,
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain (not wrapped) huber loss for non-angular features."""
    return _masked_mean(_huber(target - input, beta), mask, count)


def l1_loss(input: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None,
            count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain L1 loss for non-angular features."""
    return _masked_mean((target - input).abs(), mask, count)


def _pair_mask(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """(B, N, N) float mask of the pairs (i, j) with i < j < length_b."""
    idx = torch.arange(n, device=lengths.device)
    upper = idx[None, :, None] < idx[None, None, :]
    within = idx[None, None, :] < lengths[:, None, None]
    return (upper & within).float()


def pair_count(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """The valid pairs i < j < length of a batch padded to n, summed over its items."""
    return _pair_mask(lengths, n).sum()


def pairwise_dist_loss(
    input: torch.Tensor,
    target: torch.Tensor,
    lengths: torch.Tensor,
    weights: Optional[torch.Tensor | float] = None,
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """
    MSE between the pairwise-distance sets of input and target coordinates.

    input, target: (B, N, 3); lengths: (B,) valid point counts; weights: a
    scalar or (B,) per-item coefficient. The mean is over all valid pairs of
    the batch (count, if given), so longer items contribute more pairs
    (reference losses.py:136-149).
    """
    if input.ndim != 3 or input.shape[-1] != 3:
        raise ValueError(f"input must be (B, N, 3), got {tuple(input.shape)}")

    def pdists(x):
        diff = x[:, :, None, :] - x[:, None, :, :]
        # The floor keeps the zero diagonal's gradient finite
        return torch.sqrt(torch.clamp_min((diff * diff).sum(-1), 1e-12))

    mask = _pair_mask(lengths, input.shape[1])
    se = (pdists(input) - pdists(target)) ** 2
    if isinstance(weights, (int, float)):  # a host scalar, not copied to the device
        se = se * weights
    elif weights is not None:
        w = torch.as_tensor(weights, dtype=se.dtype, device=se.device)
        if w.ndim >= 1:
            w = w.reshape(-1)[:, None, None]
        se = se * w
    return (se * mask).sum() / (mask.sum() if count is None else count).clamp_min(1.0)
