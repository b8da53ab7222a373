"""The correctness checks at a toy size on the CPU: sound runs pass; the
control (the program at the next precision below the configuration's,
BF16_BF16_F32 for TF32) and each planted fault (faults.py) come out not
correct."""
from __future__ import annotations

import pytest
import torch

from benchmark.harness import runner
from benchmark.tests import faults, toy

# the faults each kind of cell can have (one chip: no exchange between chips to leave out)
FAULTS = {"toy.sweep": list(faults.FAULTS), "toy.train": [f for f in faults.FAULTS if f not in faults.SAMPLING_ONLY]}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("toy")
    return tmp, toy.make(tmp)


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


def run(bench, cell, **kw):
    tmp, folder = bench
    return runner.run(cell, 2**33 + 17, 0.01, False, tmp, device="cpu", require_chip=False, bench_dir=folder, **kw)


@pytest.mark.parametrize("cell", list(toy.CELLS))
def test_a_sound_run_is_correct(bench, cell):
    assert run(bench, cell)["correct"]


@pytest.mark.parametrize("cell", list(toy.CELLS))
def test_the_control_is_not_correct(bench, cell):
    line = run(bench, cell, overrides={"matmul_precision": "BF16_BF16_F32"})
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_a_planted_fault_is_not_correct(bench, cell, fault):
    with faults.FAULTS[fault]():
        line = run(bench, cell)
    assert not line["correct"], line["checks"]
