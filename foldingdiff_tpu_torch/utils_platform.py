"""
The advisory job lock (counterpart of foldingdiff_tpu/utils_platform.py).

A long job on the card holds the lock for its run (bin/train_torch.py, as
bin/train.py:108 does), so that contention-sensitive work on the same host
can ask `host_busy_reason()` and stand aside. The lock is a file holding the
owner's pid, under the temporary directory; a lock whose pid is dead is
ignored. The JAX module's `maybe_force_cpu` has no counterpart: the port's
CLIs take --device (and --cpu), and nothing chooses a device behind them.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import torch

JOB_LOCK = os.path.join(tempfile.gettempdir(), "foldingdiff_tpu_torch_job.lock")
BUSY_LOAD_PER_CORE = 1.75


@contextlib.contextmanager
def job_lock():
    """Mark this process as a long-running job on the card while the block
    runs (best effort, advisory; never raises)."""
    path = JOB_LOCK
    mine = False
    try:
        with open(path, "w") as f:
            f.write(str(os.getpid()))
        mine = True
    except OSError:
        pass
    try:
        yield
    finally:
        if mine:
            try:
                with open(path) as f:
                    if f.read().strip() == str(os.getpid()):
                        os.remove(path)
            except OSError:
                pass


def job_lock_if_cuda(device: torch.device | str):
    """job_lock() when `device` is a card, else a context that does
    nothing: CPU runs (the tests, --device cpu) do not contend for it."""
    return job_lock() if torch.device(device).type == "cuda" else contextlib.nullcontext()


def host_busy_reason() -> Optional[str]:
    """Why the host counts as contended now, or None: a job lock held by a
    live pid (a stale lock from a dead pid is ignored), or a 1-minute load
    average of at least 1.75 per core."""
    try:
        with open(JOB_LOCK) as f:
            pid = int(f.read().strip())
        os.kill(pid, 0)  # ProcessLookupError if the owner died
        return f"job lock held by live pid {pid} ({JOB_LOCK})"
    except (OSError, ValueError):
        pass
    try:
        per_core = os.getloadavg()[0] / (os.cpu_count() or 1)
    except OSError:
        return None
    if per_core >= BUSY_LOAD_PER_CORE:
        return f"1-min loadavg {per_core:.2f}/core >= {BUSY_LOAD_PER_CORE}"
    return None
