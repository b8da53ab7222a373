"""
The port's entry points run on the card unless the caller asks for the CPU.
`require_device` turns the caller's choice into a torch.device and raises at
once when it names CUDA and there is none: nothing falls back to the CPU.
"""
from __future__ import annotations

import torch


def require_device(device: torch.device | str, what: str = "device") -> torch.device:
    """torch.device(device), refused with "<what> <device>: no CUDA device is
    available" when it is a CUDA device and torch.cuda.is_available() is false."""
    resolved = torch.device(device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} {device}: no CUDA device is available")
    return resolved
