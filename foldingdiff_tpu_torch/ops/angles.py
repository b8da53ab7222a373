"""
Angular lattice ops on tensors (counterpart of foldingdiff_tpu/ops/angles.py).

The wrap to [-pi, pi) is floored modulo (`%` / torch.remainder), never
torch.fmod, whose result takes the sign of the dividend.
"""
from __future__ import annotations

import math

import torch


def wrap_angles(x: torch.Tensor, range_min: float = -math.pi, range_max: float = math.pi) -> torch.Tensor:
    """Wrap values into [range_min, range_max) with floored modulo. Operators
    only, so a numpy array is wrapped the same way, as numpy floors `%` too."""
    top = range_max - range_min
    return ((x - range_min) % top) + range_min


def wrap_angular_features(x: torch.Tensor, is_angular: torch.Tensor) -> torch.Tensor:
    """
    Wrap only the feature channels flagged angular.

    x: (..., F); is_angular: (F,) bool tensor on x's device. Non-angular
    channels pass through.
    """
    return torch.where(is_angular, wrap_angles(x), x)


def wrapped_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Circular mean via atan2 of the mean sine and cosine (NaN-tolerant)."""
    return torch.atan2(torch.nanmean(torch.sin(x), dim=dim), torch.nanmean(torch.cos(x), dim=dim))


def angular_difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed smallest difference a - b on the circle, in [-pi, pi)."""
    return wrap_angles(a - b)
