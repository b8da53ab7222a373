"""
One run of one cell: set-up, the measured window (traced with --trace 1),
the device's peak memory, the check for JAX in the process, the program's
state freed, the correctness check against the reference, and the result
line. The numbers compared are printed with their limits as the last
lines of standard error and under "checks", the last key of the line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark.harness import device as card
from benchmark.harness import spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "foldingdiff_tpu")
NOT_READ = 1e9


@dataclasses.dataclass
class Context:
    cell: spec.Cell
    seed: int
    device: torch.device
    trace: bool


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; and
    no Flax behind transformers' back."""
    base = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, str(base / sub))
    os.environ.setdefault("USE_FLAX", "0")


def jax_loaded() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run(cell_name: str, seed: int, seconds: float, traced: bool, root: Path, *, device: str = "cuda",
        require_chip: bool = True, bench_dir: Path = spec.BENCH_DIR, overrides: Optional[dict] = None,
        t_start: Optional[float] = None, readings: Optional[dict] = None) -> Optional[dict]:
    """The result line's object, or None when the run must print none.
    `readings`, when given, receives every number the check read;
    `overrides` replaces keys of the configuration (the control)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(cell_name, root, bench_dir)
    cell.config |= overrides or {}
    if require_chip:
        card.require(cell.chips)
    cache_dirs(root)
    from foldingdiff_tpu_torch.precision import set_process_default

    set_process_default()  # TF32 for the process's float32 GEMMs, as the command-line programs set
    dev = torch.device(device)
    driver = spec.driver(cell).Driver(Context(cell, seed, dev, traced))
    t_setup = time.perf_counter()
    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    print(f"setup: {t_setup - t_start:.3f} s to the driver (imports, the card), {setup_s - (t_setup - t_start):.3f} s "
          f"in its set-up", file=sys.stderr)

    with trace.Window(traced, dev) as window:
        driver.window(seconds)
    described = card.describe(dev, cell.chips)
    found = jax_loaded()
    if found:
        print(f"benchmark: the process holds {found} after the window", file=sys.stderr)
        return None
    summary = window.summary()
    facts = driver.facts() | {"summary": summary}
    attempted, failed = driver.counts()
    end_to_end = driver.end_to_end() | {"setup_s": setup_s}
    driver.release()
    t_check = time.perf_counter()
    gaps = driver.check()
    print(f"check: the reference took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    if readings is not None:
        readings.update({k: v for k, v in gaps.items() if k != "info"})

    # a number the check could not read (no chunk left to follow, say) fails
    checks = {name: {"value": gaps.get(name, NOT_READ), "limit": limit} for name, limit in cell.limits.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(cell, m["name"]).read(facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            described |= {"busy_s": summary.busy_s, "window_s": summary.window_s}
    else:
        metrics = {m["name"]: {"value": end_to_end[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": described}
    if summary is not None:
        line["breakdown"] = summary.breakdown()
        print(f"trace: {summary.n_ops} device operations reduced in {summary.reduce_s:.3f} s", file=sys.stderr)
    print(f"power limit: {card.power_limit()}", file=sys.stderr)
    if "info" in gaps:
        print(f"check info: {gaps['info']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    print(f"check failed {failed} of {attempted} limit 0", file=sys.stderr)
    line["checks"] = checks | {"failed": {"value": failed, "limit": 0}}
    return line


def dumps(line: dict) -> str:
    return json.dumps(line)
