"""
Full train-state checkpoints for mid-training resume (counterpart of
foldingdiff_tpu/training/checkpoint.py).

The model's state dict, the optimizer's state dict, the global step and the
epoch go into <results>/train_state/state_epoch=N.pt by torch.save; the
newest `keep` files stay. The port reads only its own files: the JAX
package's .msgpack train states hold optax states of another structure.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Optional, Tuple

import torch


def _epoch_of(path: str) -> int:
    m = re.search(r"epoch=(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1


def _states(results_dir: str):
    return sorted(glob.glob(os.path.join(results_dir, "train_state", "state_epoch=*.pt")), key=_epoch_of)


def save_train_state(
    results_dir: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int, epoch: int, keep: int = 2
) -> str:
    """Write the train state after `epoch`; returns its path."""
    out_dir = os.path.join(results_dir, "train_state")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"state_epoch={epoch}.pt")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(), "step": int(step),
                "epoch": int(epoch)}, path)
    for stale in _states(results_dir)[:-keep]:
        os.remove(stale)
    return path


def latest_train_state(results_dir: str) -> Optional[str]:
    """The newest train state's path, or None."""
    states = _states(results_dir)
    return states[-1] if states else None


def read_train_state(path: str) -> dict:
    """A train state's payload, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def apply_train_state(payload: dict, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Tuple[int, int]:
    """Load a train state's payload into model and optimizer in place;
    returns (global step, the epoch to continue at)."""
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    return int(payload["step"]), int(payload["epoch"]) + 1

