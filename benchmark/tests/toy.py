"""A toy benchmark for the CPU tests: a copy of the benchmark's folder with
new files only (tiny configurations beside the real ones, their traffic
and limits) and a BENCHMARK.json that adds toy cells, each named after the
real cell whose limits and metrics it takes."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = {"num_hidden_layers": 2, "hidden_size": 32, "intermediate_size": 64, "num_heads": 4, "max_seq_len": 32,
        "timesteps": 20, "batch_size": 8}
TRAFFIC = {
    "toy-sweep": {"driver": "sweep", "n_per_length": 2, "lengths": [10, 32], "record_rows": 3,
                  "record_jobs": 2},
    "toy-train": {"driver": "train", "corpus": 64, "full_share": 0.5, "min_len": 8, "reference_steps": 3},
}
# toy cell -> (configuration, tiny widths over it, traffic, the benchmark's cell whose limits and metrics it
# takes)
CELLS = {
    "toy.sweep": ("foldingdiff-cath-cosine", TINY, "toy-sweep", "cath-cosine.ddpm-sweep"),
    "toy.train": ("foldingdiff-cath-cosine", TINY, "toy-train", "cath-cosine.train-b64"),
}


def make(tmp: Path, cells=CELLS) -> Path:
    """tmp/BENCHMARK.json and tmp/benchmark/, the real files untouched and
    the toy ones added; returns the benchmark folder."""
    bench = tmp / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (config, widths, traffic, like) in cells.items():
        cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text()) | widths
        (bench / "configs" / f"toy-{config}.json").write_text(json.dumps(cfg))
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(TRAFFIC[traffic]))
        shutil.copy(BENCH / "limits" / f"{like}.json", bench / "limits" / f"{name}.json")
        spec["workloads"].append({"name": name, "config": f"toy-{config}", "traffic": traffic, "chips": 1, "why": "toy"})
        for metric in spec["end_to_end"] + spec["per_layer"]:
            if like in metric.get("workloads", ()):
                metric["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench
