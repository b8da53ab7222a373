"""The program under test, foldingdiff_tpu_torch, built from a
configuration file and the benchmark's weights, and its launch counts."""
from __future__ import annotations

import dataclasses

import torch

from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.models.bert import BertForDiffusion
from foldingdiff_tpu_torch.models.config import ModelConfig
from foldingdiff_tpu_torch.ops import attention


def model(config: dict, weights: dict, device: torch.device) -> BertForDiffusion:
    """The denoiser at the configuration's widths and precision, holding
    `weights` (copied in), in eval mode. It is built on the meta device, so
    that its own init draws nothing."""
    cfg = dataclasses.replace(ModelConfig.from_train_args(config), matmul_precision=config["matmul_precision"])
    with torch.device("meta"):
        net = BertForDiffusion(cfg)
    net = net.to_empty(device=device)
    net.load_state_dict(weights, strict=True)
    return net.eval()


def schedule(config: dict, device: torch.device) -> DiffusionSchedule:
    return DiffusionSchedule.create(config["variance_schedule"], config["timesteps"], device=device)


def launches_by_instance() -> dict:
    """The v2 attention kernel's launches by instance so far (host counts,
    graph replays included)."""
    return dict(attention.REL_ATTENTION.launches_by_instance)
