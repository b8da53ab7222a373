"""
scripts/microbench_chunks_torch.py, the port's twin of
scripts/microbench_chunks.py, on the CPU at a toy size: its per-shape lines
are the JAX script's (its print's f-string, read from the source with ast
and evaluated on the same numbers) with the capture after them, with and
without CUDA graphs (eager on the CPU either way); its default shapes are the
JAX script's; without a card it exits unless asked for the CPU.
"""
import ast
import importlib.util
import os
import re

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "microbench_chunks.py")


@pytest.fixture(scope="module")
def twin():
    spec = importlib.util.spec_from_file_location(
        "_microbench_chunks_torch", os.path.join(REPO, "scripts", "microbench_chunks_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the toy chains run many tiny ops, which a thread
    pool slows down on cores that other test workers share."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def jax_script():
    with open(JAX_SCRIPT) as f:
        return ast.parse(f.read())


def jax_line(b: int, l: int, total: float, timesteps: int) -> str:
    """The JAX script's per-shape line for these numbers: the f-string of its
    print that starts with "B=", evaluated."""
    fstring = next(node.args[0] for node in ast.walk(jax_script())
                   if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print"
                   and isinstance(node.args[0], ast.JoinedStr) and node.args[0].values[0].value.startswith("B="))
    code = compile(ast.Expression(fstring), JAX_SCRIPT, "eval")
    return eval(code, {}, {"b": b, "l": l, "total": total, "T": timesteps})


@pytest.mark.parametrize("graphs", ["0", "1"])
def test_toy_run_prints_the_jax_scripts_lines(twin, graphs, monkeypatch, capsys):
    monkeypatch.setenv("MB_TIMESTEPS", "2")
    monkeypatch.setenv("MB_GRAPHS", graphs)
    results = twin.main(["2,16", "3,16", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"T=2 graphs={graphs} device=cpu (no card)" and "TPU" not in lines[0]
    assert [(b, l) for b, l, _, _ in results] == [(2, 16), (3, 16)] and len(lines) == 3
    for line, (b, l, total, first) in zip(lines[1:], results):
        assert 0 < total <= first
        assert line == f"{jax_line(b, l, total, 2)}  capture {first - total:6.3f} s"
        scan, step, per_item = (float(x) for x in re.findall(r"([\d.]+) (?:s|ms)", line)[:3])
        assert scan > 0 and step > 0 and per_item > 0


def test_exits_without_a_card_unless_asked_for_the_cpu(twin, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device is available"):
        twin.main(["2,16"])


def test_default_shapes_are_the_jax_scripts(twin):
    jax_shapes = next(ast.literal_eval(node.value) for node in ast.walk(jax_script())
                      if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "DEFAULT_SHAPES")
    assert twin.DEFAULT_SHAPES == jax_shapes and len(jax_shapes) == 10
