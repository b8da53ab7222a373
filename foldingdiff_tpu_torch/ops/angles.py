"""
Angular lattice ops (counterpart of foldingdiff_tpu/ops/angles.py).

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
