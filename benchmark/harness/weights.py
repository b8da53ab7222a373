"""
The denoiser's weights, made on the run's device from the seed: one normal
draw from a torch.Generator on that device for every parameter at once,
scaled and shifted per tensor by the init reference.denoiser names, then
split into views, one per state-dict name. The program and the reference
get the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness import seeds
from benchmark.reference import denoiser

SCALE = {"matrix": None, "small": 0.02, "ln_weight": 0.02, "table": 1.0, "fourier": 2 * math.pi}


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    specs = denoiser.parameter_specs(config)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    scales = torch.tensor([SCALE[init] if SCALE[init] is not None else 1.0 / math.sqrt(shape[1])
                           for _, shape, init in specs], dtype=torch.float32)
    shifts = torch.tensor([1.0 if init == "ln_weight" else 0.0 for _, _, init in specs], dtype=torch.float32)
    counts = torch.tensor(sizes)
    g = torch.Generator(device=device)
    g.manual_seed(seeds.derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    counts = counts.to(device)
    flat.mul_(torch.repeat_interleave(scales.to(device), counts)).add_(torch.repeat_interleave(shifts.to(device), counts))
    return {name: part.view(shape) for (name, shape, _), part in zip(specs, flat.split(sizes))}
