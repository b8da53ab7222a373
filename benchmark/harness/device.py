"""The card: the check that the run has the chips its cell asks for, and
what the result line says of the device."""
from __future__ import annotations

import subprocess
import sys

import torch


def require(chips: int) -> None:
    """Exit non-zero, printing no result, without `chips` CUDA devices."""
    if not torch.cuda.is_available():
        sys.exit("benchmark: torch.cuda.is_available() is false; this cell needs an NVIDIA GPU")
    if torch.cuda.device_count() < chips:
        sys.exit(f"benchmark: the cell asks for {chips} GPUs, torch sees {torch.cuda.device_count()}")


def power_limit() -> str:
    """nvidia-smi's name and power limit of each card, or why there are none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def describe(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips)))}
