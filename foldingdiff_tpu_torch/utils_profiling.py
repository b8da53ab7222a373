"""
Phase timers and profiler traces (counterpart of
foldingdiff_tpu/utils_profiling.py; the reference has only per-epoch wall
clock prints).

- `phase_timer(name)`: a context manager that logs the wall time of a
  pipeline phase, "[phase] name: 1.23s (cumulative 4.56s)", and adds it to
  `phase_totals()`.
- `maybe_profile(dirname, device)`: a torch.profiler window, CPU activity
  and, when the device is a card, CUDA activity; on exit it writes a Chrome
  trace (chrome://tracing, Perfetto) into dirname. It does nothing when
  dirname is empty.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict

import torch

from foldingdiff_tpu_torch.devices import require_device

_PHASE_TOTALS: Dict[str, float] = defaultdict(float)
TRACE_NAME = "trace.json"


@contextlib.contextmanager
def phase_timer(name: str, log: bool = True):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _PHASE_TOTALS[name] += dt
        if log:
            logging.info(f"[phase] {name}: {dt:.2f}s (cumulative {_PHASE_TOTALS[name]:.2f}s)")


def phase_totals() -> Dict[str, float]:
    return dict(_PHASE_TOTALS)


@contextlib.contextmanager
def maybe_profile(dirname: str = "", device: torch.device | str = "cuda"):
    """A torch.profiler window whose Chrome trace goes to dirname/trace.json
    on exit; a no-op when dirname is empty. `device` is the card unless the
    caller asks for the CPU; without a card it raises at once."""
    if not dirname:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if require_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    out = os.path.join(dirname, TRACE_NAME)
    prof.export_chrome_trace(out)
    logging.info(f"Wrote profiler trace to {out}")
