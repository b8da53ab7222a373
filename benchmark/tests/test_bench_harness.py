"""The harness on the CPU: discovery by name, the contract's shape of
BENCHMARK.json, the result line, the frozen yardstick, the sweep's chunk
metrics and the imports."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import types

import pytest
import torch

from benchmark.harness import chains, readers, roofline, runner, spec, trace
from benchmark.reference import denoiser
from benchmark.tests import toy

ROOT, BENCH = toy.ROOT, toy.BENCH
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = spec.load_cell(cell, ROOT)
    assert hasattr(spec.driver(c), "Driver")
    for metric in c.per_layer:
        assert callable(spec.reader(c, metric["name"]).read)
    entry = next(e for e in SPEC["configs"] if e["name"] == c.config_name)
    assert (ROOT / entry["file"]).is_file() and json.loads((ROOT / entry["file"]).read_text()) == c.config
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())


def test_benchmark_json_has_the_contracts_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1].startswith("benchmark/")
    cells = {w["name"]: w for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    names = [*cells, *e2e, *(m["name"] for m in SPEC["per_layer"]), *(c["name"] for c in SPEC["configs"])]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert all(w in cells and w in moved.get("workloads", cells) for w in m["workloads"])
    for name in cells:
        reported = [m for m in SPEC["end_to_end"] if name in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(name in m["workloads"] for m in SPEC["per_layer"])
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_toy_cell_needs_only_new_files_and_prints_the_line(tmp_path):
    bench = toy.make(tmp_path, {"toy.sweep": toy.CELLS["toy.sweep"]})
    line = runner.run("toy.sweep", 2**40 + 3, 0.01, False, tmp_path, device="cpu", require_chip=False,
                      bench_dir=bench)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and line["attempted"] == 44 and line["failed"] == 0
    assert set(line["metrics"]) == {"ddpm_backbones_per_s", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    json.loads(runner.dumps(line))


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cath-cosine.train-b64", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_the_frozen_bound_and_flop_counts_at_64_by_128():
    # (B, H, L, D, M) = (64, 12, 128, 32, 128): 2 * 64 * 12 * 128^2 * 32 * 3 FLOPs against 4 bytes of
    # 4 * 64 * 12 * 128 * 32 + 64 * 128 + 255 * 32 floats
    seconds, what = roofline.attention_bound_s(64, 12, 128, 32, 128, "tf32")
    assert what == "bytes" and seconds == pytest.approx(4 * 12_599_264 / 3.35e12, rel=1e-12)
    assert roofline.attention_bound_s(64, 12, 128, 32, 128, "fma") == (2_415_919_104 / 67e12, "operations")
    cfg = json.loads((BENCH / "configs" / "foldingdiff-cath-cosine.json").read_text())
    per_position = 6 * 384 + 12 * (4 * 384 * 384 + 2 * 384 * 768) + 384 * 384 + 384 * 6
    assert denoiser.matmul_flops(cfg, 128) == 2 * (128 * per_position + 12 * 3 * 128 * 128 * 384) == 4_115_791_872
    facts = {"flops": 64 * 4_115_791_872, "window_s": 1.0, "summary": object()}
    assert readers.mfu(facts) == pytest.approx(100 * 263_410_679_808 / 495e12)


def test_the_sweeps_padding_and_chunk_shapes_on_a_toy_model(tmp_path):
    """The published sweep (10 per length in [50, 128)) through sample()'s
    chunking: 150 x 64, 512 x 128 and 118 x 128, 69,030 real positions of
    90,240."""
    wide = toy.TINY | {"max_seq_len": 128, "timesteps": 2}
    cells = {"toy.sweep": ("foldingdiff-cath-cosine", wide, "toy-sweep", "cath-cosine.ddpm-sweep")}
    bench = toy.make(tmp_path, cells)
    (bench / "traffic" / "toy-sweep.json").write_text(json.dumps(json.loads(
        (BENCH / "traffic" / "ddpm-sweep.json").read_text()) | {"record_jobs": 1}))
    cell = spec.load_cell("toy.sweep", tmp_path, bench)
    driver = spec.driver(cell).Driver(runner.Context(cell, 5, torch.device("cpu"), False))
    driver.setup()
    driver.window(1e-3)
    facts = driver.facts()
    assert sorted((b, l) for b, l, _, _ in facts["chunks"]) == [(118, 128), (150, 64), (512, 128)]
    assert spec.reader(cell, "sweep.padded_share").read(facts) == pytest.approx(100 * (1 - 69_030 / 90_240))
    assert spec.reader(cell, "sweep.chunk_shapes").read(facts) == 3


def _event(name, kind=None, annotation=None):
    """A kineto event as harness/trace.py reads it: with activity_type() where
    the profiler gives one, else with is_user_annotation() or neither."""
    fields = {"name": lambda: name}
    if kind is not None:
        fields["activity_type"] = lambda: kind
    if annotation is not None:
        fields["is_user_annotation"] = lambda: annotation
    return types.SimpleNamespace(**fields)


@pytest.mark.parametrize("event,operation", [
    (_event("sm90_xmma_gemm", kind="kernel"), True), (_event("Memset (Device)", kind="gpu_memset"), True),
    (_event("Memcpy DtoD", kind="gpu_memcpy"), True), (_event("optimizer", kind="gpu_user_annotation"), False),
    (_event("sm90_xmma_gemm", annotation=False), True), (_event("optimizer", annotation=True), False),
    (_event("bench.sweep.job"), False), (_event("rel_attention_tf32_kernel"), True)])
def test_a_device_operation_is_a_kernel_a_copy_or_a_memset(event, operation):
    assert trace._device_operation(event) is operation


def test_a_jobs_rows_map_to_its_requests_in_request_order():
    requested = [5, 5, 7, 7, 5, 9]
    # chunks as they ran: the short bucket first, each keeping request order within a length
    assert chains.requests_of(requested, [[5, 5, 5], [7, 9, 7]]) == [[0, 1, 4], [2, 5, 3]]
    assert chains.requests_of(requested, [[5, 5, 5], [7, 9]]) is None  # a request never ran
    assert chains.requests_of(requested, [[5, 5, 5, 5], [7, 9, 7]]) is None  # a row with no request


FORBIDDEN_CHECK = """
import sys, json
sys.path.insert(0, {root!r})
from pathlib import Path
from benchmark.harness import runner
from benchmark.tests import toy
bench = toy.make(Path({tmp!r}))
for cell in toy.CELLS:
    runner.run(cell, 7, 0.01, False, Path({tmp!r}), device="cpu", require_chip=False, bench_dir=bench)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_module_the_benchmark_loads_is_jax_or_the_jax_package(tmp_path):
    out = subprocess.run([sys.executable, "-c", FORBIDDEN_CHECK.format(root=str(ROOT), tmp=str(tmp_path))],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "foldingdiff_tpu_torch" in loaded and not loaded & set(runner.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for name in names:
                assert name.split(".")[0] in ("__future__", "math", "typing", "numpy", "torch", "benchmark"), name
                assert not name.startswith("benchmark.") or name.startswith("benchmark.reference"), name
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.training, benchmark.reference.diffusion;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "foldingdiff_tpu_torch" not in out.stdout and "'jax'" not in out.stdout


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cath-cosine.train-b64", "--seed",
                          str(2**35 + 1), "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
