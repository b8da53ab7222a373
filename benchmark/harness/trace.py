"""
The traced run's device trace: torch.profiler over the measured window
(CPU and CUDA activity, no shapes, no stacks, no Chrome export), reduced in
one pass over kineto's events to what the readers need: each device
operation's count and time by name, the time any operation ran (the union
of their intervals), and the idle gaps between them, each named by the
harness span (`span`, a record_function named "bench.<what>") that the host
was in when the gap began.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SPAN_PREFIX = "bench."
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A host span the trace names idle gaps by (free when nothing traces)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[int, float]]  # name -> (count, seconds)
    idle_by_span: Dict[str, float]
    reduce_s: float

    @property
    def n_ops(self) -> int:
        return sum(n for n, _ in self.ops.values())

    def seconds_of(self, needle: str) -> Tuple[int, float]:
        """(count, seconds) of the operations whose name holds `needle`."""
        hits = [v for k, v in self.ops.items() if needle in k]
        return sum(n for n, _ in hits), sum(s for _, s in hits)

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, s] for k, (_, s) in top], "idle_gaps": [[k, s] for k, s in gaps]}


class Window:
    """The measured window, traced when `enabled`: `with Window(True) as w:`
    then w.summary() after the block."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled and device.type == "cuda"
        self.device = device
        self.prof: Optional[torch.profiler.profile] = None
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Window":
        if self.enabled:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.end_ns = time.perf_counter_ns()
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def summary(self) -> Optional[Summary]:
        if self.prof is None:
            return None
        t0 = time.perf_counter()
        ops = collections.defaultdict(lambda: [0, 0])
        intervals, spans = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not _device_operation(e):
                    continue
                start, dur = e.start_ns(), e.duration_ns()
                entry = ops[e.name()]
                entry[0] += 1
                entry[1] += dur
                intervals.append((start, start + dur))
            elif e.name().startswith(SPAN_PREFIX):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(SPAN_PREFIX):]))
        busy, gaps = _merge(intervals)
        window_ns = self.end_ns - self.start_ns
        first = min((s for s, _ in intervals), default=0)
        # the host's clock and the trace's share no origin: the window is the
        # host's, and the trace's busy time lies inside it
        idle = _label(gaps, spans)
        if intervals:
            lead = max(window_ns - (max(e for _, e in intervals) - first), 0)
            idle["before the first or after the last device operation"] = lead / 1e9
        return Summary(window_s=window_ns / 1e9, busy_s=busy / 1e9,
                       ops={k: (n, ns / 1e9) for k, (n, ns) in ops.items()},
                       idle_by_span=idle, reduce_s=time.perf_counter() - t0)


def _device_operation(e) -> bool:
    """A kernel, copy or memset, and not a user annotation's range on the
    device (record_function's, the program's "optimizer" among them)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    annotation = getattr(e, "is_user_annotation", None)
    return not (annotation is not None and annotation()) and not e.name().startswith(SPAN_PREFIX)


def _merge(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(union length, gaps between the merged intervals) in ns."""
    if not intervals:
        return 0, []
    arr = np.array(intervals, dtype=np.int64)
    arr = arr[np.argsort(arr[:, 0], kind="stable")]
    ends = np.maximum.accumulate(arr[:, 1])
    gap_after = arr[1:, 0] > ends[:-1]
    starts_of_runs = np.concatenate([[arr[0, 0]], arr[1:, 0][gap_after]])
    ends_of_runs = np.concatenate([ends[:-1][gap_after], [ends[-1]]])
    busy = int((ends_of_runs - starts_of_runs).sum())
    gaps = list(zip(ends_of_runs[:-1].tolist(), starts_of_runs[1:].tolist()))
    return busy, gaps


def _label(gaps: List[Tuple[int, int]], spans: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Idle seconds by the innermost span open at each gap's start."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    out: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        label = "no harness span"
        for s, e, name in reversed(spans[max(0, i - 64):i]):
            if s <= g0 < e:
                label = name
                break
        out[label] += (g1 - g0) / 1e9
    return dict(out)

