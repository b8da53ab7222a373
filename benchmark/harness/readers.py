"""What the per-layer readers (metrics/<name>.py) share. A reader takes the
run's facts (the driver's, and `summary`, the device trace's) and returns a
number, or None where it finds nothing to read: a share of a roofline or of
a peak is never 0 for want of a reading."""
from __future__ import annotations

from typing import Optional

from benchmark.harness import roofline
from benchmark.reference import denoiser


def idle_share(facts: dict) -> Optional[float]:
    s = facts.get("summary")
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def device_ops_per(facts: dict, units: int) -> Optional[float]:
    s = facts.get("summary")
    if s is None or not units or not s.n_ops:
        return None
    return s.n_ops / units


def steps_run(facts: dict) -> int:
    return facts.get("steps_run", 0)


def mfu(facts: dict) -> Optional[float]:
    """The model's GEMM FLOPs over the window's time on the host's clock and
    the TF32 peak (read in the traced run, beside its busy time)."""
    if not facts.get("flops") or facts.get("summary") is None:
        return None
    return 100.0 * facts["flops"] / facts["window_s"] / roofline.TF32_PEAK


def attention_roofline(facts: dict) -> Optional[float]:
    """The least time of every v2 attention call of the window's chunks
    (each chunk's steps times its layers, at (B, H, L, D) and the table of
    2M - 1 rows, for the instance that ran) over the device time of that
    instance's kernel; None unless the host's launch counts agree with the
    calls and the trace holds the kernel."""
    s, launches = facts.get("summary"), facts.get("launches") or {}
    ran = [k for k, n in launches.items() if n]
    if s is None or len(ran) != 1:
        return None
    instance = ran[0]
    w = denoiser.widths(facts["config"])
    calls = steps_run(facts) * w["layers"]
    if calls != launches[instance]:
        return None
    least = sum(facts["steps_per_chunk"] * w["layers"]
                * roofline.attention_bound_s(b, w["heads"], l, w["head"], w["max_pos"], instance)[0]
                for b, l, _, _ in facts["chunks"])
    name = "rel_attention_kernel" if instance == "fma" else f"rel_attention_{instance}_kernel"
    n, seconds = s.seconds_of(name)
    if not n or seconds <= 0:
        return None
    return 100.0 * least / seconds
