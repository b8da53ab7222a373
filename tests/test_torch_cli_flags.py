"""
The port's CLIs (bin/<name>_torch.py) take every option of their JAX twins
(bin/<name>.py), so that a JAX command line runs on the port unchanged: each
JAX parser's option strings, read from its source (the JAX CLIs import JAX
when they build their parsers, and some build them inside main()), against
the port parser's. Then --ngpu of bin/train_torch.py (accepted and unused,
as in bin/train.py) and --cpu of bin/partial_noise_reconstruct_torch.py
(--device cpu, never a fallback), driven through main().
"""
import argparse
import ast
import importlib.util
import os

import pytest
import torch

from foldingdiff_tpu_torch.training import orchestration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin")
SUFFIX = "_torch.py"
TWINS = sorted(f[: -len(SUFFIX)] for f in os.listdir(BIN)
               if f.endswith(SUFFIX) and os.path.isfile(os.path.join(BIN, f[: -len(SUFFIX)] + ".py")))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_flags_{name}", os.path.join(BIN, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_option_strings(name: str) -> list:
    """The option strings (-x, --xyz) of every add_argument call in bin/<name>.py."""
    with open(os.path.join(BIN, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    return [arg.value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "add_argument"
            for arg in node.args if isinstance(arg, ast.Constant) and str(arg.value).startswith("-")]


def test_every_port_cli_has_a_jax_twin_with_options():
    assert len(TWINS) == 17 and all(jax_option_strings(name) for name in TWINS)


def option_strings(parser: argparse.ArgumentParser) -> set:
    """The option strings of a parser and of its subcommands' parsers."""
    out = set()
    for action in parser._actions:
        out.update(action.option_strings)
        if isinstance(action, argparse._SubParsersAction):
            for sub in action.choices.values():
                out |= option_strings(sub)
    return out


@pytest.mark.parametrize("name", TWINS)
def test_port_cli_takes_every_option_of_its_jax_twin(name):
    ours = option_strings(_load(f"{name}_torch").build_parser())
    missing = sorted(set(jax_option_strings(name)) - ours)
    assert not missing, f"bin/{name}{SUFFIX} refuses bin/{name}.py's {missing}"


def test_train_cli_takes_ngpu_and_passes_it_on_unused(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(orchestration, "train", lambda **kwargs: (seen.update(kwargs), (None, []))[1])
    assert _load("train_torch").main(["--ngpu", "1", "--cpu", "-o", str(tmp_path)]) == []
    assert seen["ngpu"] == 1 and seen["device"] == "cpu"


def test_reconstruction_cli_takes_cpu_as_the_cpu_device(monkeypatch, tmp_path):
    """--cpu runs on the CPU where no card is (it gets as far as the model
    directory, which is missing); without it the card is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli = _load("partial_noise_reconstruct_torch")
    argv = ["-m", str(tmp_path / "no_model"), "--data", str(tmp_path), "-o", str(tmp_path / "x.json")]
    with pytest.raises(FileNotFoundError, match="no_model"):
        cli.main([*argv, "--cpu"])
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device is available"):
        cli.main(argv)
