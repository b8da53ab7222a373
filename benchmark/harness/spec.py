"""
Finding everything of a cell by name, so that a new configuration, traffic
mix or per-layer metric is new files only:

- BENCHMARK.json at the checkout's root: the cell's configuration and
  traffic names and its metrics;
- configs/<config>.json: the configuration as it is run;
- traffic/<traffic>.json: the traffic mix, whose "driver" names the code
  that runs it, drivers/<driver>.py;
- limits/<cell>.json: the limits of the cell's correctness numbers;
- metrics/<metric>.py: the reader of one per-layer metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def load_cell(name: str, root: Path, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files from bench_dir."""
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[_checked(name)]

    def applies(metric: dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"], config=_json(bench_dir / "configs" / f"{_checked(w['config'])}.json"),
        traffic_name=w["traffic"], traffic=_json(bench_dir / "traffic" / f"{_checked(w['traffic'])}.json"),
        limits=_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
        bench_dir=bench_dir,
    )


def load_module(path: Path, name: str) -> ModuleType:
    """A benchmark file imported by its path, under benchmark.<name>."""
    key = "benchmark._loaded." + re.sub(r"[^A-Za-z0-9_]", "_", name)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def driver(cell: Cell) -> ModuleType:
    kind = _checked(cell.traffic["driver"])
    return load_module(cell.bench_dir / "drivers" / f"{kind}.py", f"driver_{kind}")


def reader(cell: Cell, metric: str) -> ModuleType:
    return load_module(cell.bench_dir / "metrics" / f"{_checked(metric)}.py", f"metric_{metric}")
