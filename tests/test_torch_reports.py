"""
The port's host reports on the CPU: the eight plotting functions and the
three structure renders (each writes a non-empty file; the SS counts' JSON
equals the JAX package's), bin/sample_torch.py's report (--testcomparison's
test split against JAX's loop, ks_tests.json against scipy, the numbers
written and one warning where matplotlib is refused, nothing under
--noplot), train()'s KL diagnostics with and without matplotlib, the
profiler window and phase timers, and the advisory job lock.
"""
import importlib.util
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import stats

from examples.synthetic_proteins_torch import synth_angles
from foldingdiff_tpu.data.datasets import DATASET_CLASSES as JAX_DATASET_CLASSES
from foldingdiff_tpu.metrics import plotting as jax_plotting
from foldingdiff_tpu_torch import utils_platform, utils_profiling
from foldingdiff_tpu_torch.data.datasets import NoisedAnglesDataset
from foldingdiff_tpu_torch.geometry.featurize import EXHAUSTIVE_ANGLES, create_new_chain_nerf
from foldingdiff_tpu_torch.metrics import plotting, struct_vis
from foldingdiff_tpu_torch.training import orchestration
from tests.helpers import make_synthetic_pdb_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_FIXTURE = os.path.join(REPO, "tests", "mini_model_for_testing", "results")
FT_NAMES = ["phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA"]
FIGURES = {"ramachandran_generated.pdf", "generated_distributions.pdf", "generated_distributions_cdf.pdf",
           "ss_cooccurrence_generated.pdf"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager sampling and training loops here run
    many tiny ops, which a thread pool slows down, the more so on cores that
    other test workers share."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib refused by an import hook, as on a machine without it."""
    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] == "matplotlib":
                raise ModuleNotFoundError(f"No module named {name!r} (refused)", name=name)
            return None

    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(sys, "meta_path", [Refuse(), *sys.meta_path])


@pytest.fixture(scope="module")
def pdb_dir(tmp_path_factory):
    """16 jittered 1CRN backbones of 40-46 residues (few enough to featurize
    without a process pool); the mini fixture's test split (pad 64, min
    length 40) holds 2 of them."""
    d = tmp_path_factory.mktemp("pdbs")
    make_synthetic_pdb_dir(str(d), n=16, seed=3, min_len=40)
    return str(d)


@pytest.fixture
def cache_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("FOLDINGDIFF_CACHE_DIR", str(tmp_path))


def _sample_cli():
    spec = importlib.util.spec_from_file_location("sample_torch_reports", os.path.join(REPO, "bin", "sample_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Clean:
    """A clean dataset of 4 seeded structures of 30 residues, padded to 40."""
    feature_names = {"angles": FT_NAMES}
    feature_is_angular = {"angles": [True] * 6}
    pad = 40

    def __len__(self):
        return 4

    def __getitem__(self, i, ignore_zero_center=False):
        angles = np.zeros((40, 6), np.float32)
        angles[:30] = synth_angles(np.random.default_rng(i), 30)
        return {"angles": angles, "attn_mask": (np.arange(40) < 30).astype(np.float32), "lengths": np.array(30)}


def _plots(tmp_path):
    rng = np.random.default_rng(0)
    values = rng.uniform(-np.pi, np.pi, (200, 6))
    metrics = tmp_path / "metrics.csv"
    metrics.write_text("epoch,train_loss,val_loss,train_loss_phi\n0,1.0,,0.5\n1,0.8,0.9,0.4\n2,0.7,0.85,0.3\n")
    noised = NoisedAnglesDataset(_Clean(), timesteps=10, seed=0)
    return {
        "plot_losses": lambda: [plotting.plot_losses(str(metrics), str(tmp_path / "l.pdf"), simple=False)],
        "plot_ramachandran": lambda: [plotting.plot_ramachandran(values[:, 0], values[:, 1], str(tmp_path / "r.pdf"),
                                                                 annot_ss=True)],
        "plot_distribution_overlap": lambda: [plotting.plot_distribution_overlap(
            {"a": values, "b": values[::-1] * 0.5}, str(tmp_path / "d.pdf"), FT_NAMES, cumulative=True)],
        "plot_val_dists_at_t": lambda: [plotting.plot_val_dists_at_t(values, values * 0.3, 5, FT_NAMES,
                                                                     str(tmp_path / "v.pdf"))],
        "plot_timestep_distributions": lambda: plotting.plot_timestep_distributions(noised, 10, str(tmp_path),
                                                                                    n_intervals=3),
        "plot_ss_cooccurrence": lambda: [plotting.plot_ss_cooccurrence([1, 2, 0, 3], [0, 1, 1, 2],
                                                                       str(tmp_path / "s.pdf"))],
        "plot_kl_divergence": lambda: [plotting.plot_kl_divergence(np.abs(values[:20]), FT_NAMES,
                                                                   str(tmp_path / "k.pdf"))],
        "plot_consecutive_heatmap": lambda: [plotting.plot_consecutive_heatmap(values[:, 0], str(tmp_path / "h.pdf"))],
    }


@pytest.mark.parametrize("name", ["plot_losses", "plot_ramachandran", "plot_distribution_overlap",
                                  "plot_val_dists_at_t", "plot_timestep_distributions", "plot_ss_cooccurrence",
                                  "plot_kl_divergence", "plot_consecutive_heatmap"])
def test_plotting_function_writes_a_file(name, tmp_path):
    written = _plots(tmp_path)[name]()
    assert written and all(os.path.getsize(f) > 0 for f in written)
    if name == "plot_timestep_distributions":
        assert sorted(os.path.basename(f) for f in written) == [f"train_dists_at_t_{t}.pdf" for t in (0, 4, 9)]


def test_plot_ss_cooccurrence_json_matches_jax(tmp_path):
    alpha, beta = (np.int64(2), 0, 5, 1), [3, 3, 0, 1]
    plotting.plot_ss_cooccurrence(alpha, beta, str(tmp_path / "ours.pdf"), json_file=str(tmp_path / "ours.json"))
    jax_plotting.plot_ss_cooccurrence(alpha, beta, str(tmp_path / "jax.pdf"), json_file=str(tmp_path / "jax.json"))
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.mark.parametrize("render", ["pdb2png", "pdb2png_batch", "pdb2gif"])
def test_struct_vis_writes_a_file(render, tmp_path):
    rng = np.random.default_rng(1)
    pdbs = [create_new_chain_nerf(str(tmp_path / f"f{i}.pdb"), synth_angles(rng, 35), EXHAUSTIVE_ANGLES)
            for i in range(3)]
    written = {"pdb2png": lambda: [struct_vis.pdb2png(pdbs[0], str(tmp_path / "a.png"))],
               "pdb2png_batch": lambda: struct_vis.pdb2png_batch(pdbs, str(tmp_path / "pngs")),
               "pdb2gif": lambda: [struct_vis.pdb2gif(pdbs, str(tmp_path / "t.gif"), stride=1)]}[render]()
    assert len(written) == (3 if render == "pdb2png_batch" else 1)
    assert all(os.path.getsize(f) > 0 for f in written)


def test_test_split_angles_match_jax_loop(pdb_dir, cache_in_tmp):
    """--testcomparison's rows: the test split's unpadded, uncentred angles,
    as bin/sample.py:239-258 gathers them from the JAX dataset."""
    train_args = json.load(open(os.path.join(MINI_FIXTURE, "training_args.json")))
    ours = _sample_cli().test_split_angles(pdb_dir, train_args)
    test_ds = JAX_DATASET_CLASSES[train_args["angles_definitions"]](
        pdbs=pdb_dir, split="test", pad=train_args["max_seq_len"], min_length=train_args["min_seq_len"],
        trim_strategy=train_args["trim_strategy"], zero_center=False)
    rows = []
    for i in range(len(test_ds)):
        item = test_ds.__getitem__(i, ignore_zero_center=True)
        rows.append(item["angles"][: int(item["lengths"])])
    theirs = np.concatenate(rows)
    assert ours.shape == theirs.shape and ours.shape[0] >= 80
    np.testing.assert_allclose(ours, theirs, atol=1e-12, rtol=0)


def test_sample_report_without_matplotlib(pdb_dir, cache_in_tmp, tmp_path, no_matplotlib, caplog):
    """With matplotlib refused, bin/sample_torch.py warns once, before
    sampling, naming the package and the four figures, then writes
    ks_tests.json (per feature, scipy's two-sample KS of the sampled angles
    against the test split, as a (statistic, p) pair) and ss_counts.json."""
    cli = _sample_cli()
    out = tmp_path / "out"
    with caplog.at_level(logging.INFO):
        result = cli.main(["-m", MINI_FIXTURE, "--device", "cpu", "-n", "1", "-l", "40", "43", "-b", "4", "-o",
                           str(out), "--method", "ddim", "--ddim_steps", "5", "--testcomparison", pdb_dir])
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "matplotlib" in warnings[0] and all(f in warnings[0] for f in FIGURES)
    messages = [r.getMessage() for r in caplog.records]
    assert messages.index(warnings[0]) < min(i for i, m in enumerate(messages) if m.startswith("[phase] sampling"))
    assert set(os.listdir(out / "plots")) == {"ks_tests.json", "ss_counts.json"} == set(result["report"])
    sampled = np.concatenate([np.loadtxt(out / "sampled_angles" / f"generated_{i}.csv.gz", delimiter=",",
                                         skiprows=1) for i in range(3)])
    test = cli.test_split_angles(pdb_dir, json.load(open(os.path.join(MINI_FIXTURE, "training_args.json"))))
    ks = json.loads((out / "plots" / "ks_tests.json").read_text())
    assert list(ks) == FT_NAMES
    for i, name in enumerate(FT_NAMES):
        ref = stats.ks_2samp(sampled[:, i], test[:, i])
        np.testing.assert_allclose(ks[name], [ref.statistic, ref.pvalue], rtol=1e-12)
    counts = json.loads((out / "plots" / "ss_counts.json").read_text())
    assert len(counts["alpha"]) == len(counts["beta"]) == 3


def test_sample_report_noplot_writes_neither(tmp_path):
    result = _sample_cli().main(["-m", MINI_FIXTURE, "--cpu", "-n", "1", "-l", "40", "42", "-b", "2", "-o",
                                 str(tmp_path), "--method", "ddim", "--ddim_steps", "5", "--noplot"])
    assert result["report"] == {} and not (tmp_path / "plots").exists() and len(result["pdb_files"]) == 2


def _train(pdb_dir, results):
    config = json.load(open(os.path.join(MINI_FIXTURE, "training_args.json")))
    return orchestration.train(**{**config, "results_dir": str(results), "dataset_key": pdb_dir, "max_epochs": 1,
                                  "min_epochs": 1, "multithread": False, "device": "cpu"})


def test_train_writes_kl_diagnostics(pdb_dir, cache_in_tmp, tmp_path):
    """Without dryrun, train() writes the KL array, its figure, the
    per-timestep distributions and the loss plot."""
    _, rows = _train(pdb_dir, tmp_path / "r")
    kl = np.load(tmp_path / "r" / "kl_divergence_timesteps.npy")
    assert kl.shape == (250, 6) and not np.isnan(kl).any() and len(rows) == 1  # a bin empty in the noise gives inf
    plots = set(os.listdir(tmp_path / "r" / "plots"))
    assert {"kl_divergence_timesteps.pdf", "losses.pdf", "train_dists_at_t_0.pdf", "train_dists_at_t_249.pdf"} <= plots
    assert all(os.path.getsize(tmp_path / "r" / "plots" / p) > 0 for p in plots)


def test_train_without_matplotlib_warns_and_finishes(pdb_dir, cache_in_tmp, tmp_path, no_matplotlib, caplog):
    with caplog.at_level(logging.WARNING):
        _, rows = _train(pdb_dir, tmp_path / "r")
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and warnings[0].startswith("matplotlib not installed")
    assert "kl_divergence_timesteps.pdf" in warnings[0] and "losses.pdf" in warnings[0]
    assert len(rows) == 1 and (tmp_path / "r" / "kl_divergence_timesteps.npy").is_file()
    assert not (tmp_path / "r" / "plots").exists()


def test_maybe_profile_writes_a_chrome_trace(tmp_path):
    with utils_profiling.maybe_profile(str(tmp_path / "prof"), "cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / utils_profiling.TRACE_NAME).read_text())
    assert any(e.get("name") == "aten::matmul" for e in trace["traceEvents"])
    with utils_profiling.maybe_profile(""):  # no directory: nothing, not even a device check
        pass


def test_phase_totals_add_up_across_calls(caplog):
    before = utils_profiling.phase_totals().get("test phase", 0.0)
    with caplog.at_level(logging.INFO):
        for _ in range(3):
            with utils_profiling.phase_timer("test phase"):
                pass
    total = utils_profiling.phase_totals()["test phase"]
    assert total >= before and sum("[phase] test phase" in r.getMessage() for r in caplog.records) == 3
    with utils_profiling.phase_timer("test phase", log=False):
        sum(range(10000))
    assert utils_profiling.phase_totals()["test phase"] > total


def test_job_lock_held_then_removed(tmp_path, monkeypatch):
    lock = tmp_path / "job.lock"
    monkeypatch.setattr(utils_platform, "JOB_LOCK", str(lock))
    monkeypatch.setattr(os, "getloadavg", lambda: (0.0, 0.0, 0.0))
    assert utils_platform.host_busy_reason() is None
    with utils_platform.job_lock_if_cuda("cuda"):
        assert lock.read_text() == str(os.getpid())
        assert f"live pid {os.getpid()}" in utils_platform.host_busy_reason()
    assert not lock.exists() and utils_platform.host_busy_reason() is None
    with utils_platform.job_lock_if_cuda("cpu"):  # a CPU run takes no lock
        assert not lock.exists()
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    lock.write_text(str(dead.pid))  # a stale lock: its owner is gone
    assert utils_platform.host_busy_reason() is None
    monkeypatch.setattr(os, "getloadavg", lambda: (2.0 * (os.cpu_count() or 1), 0.0, 0.0))
    assert "loadavg 2.00/core" in utils_platform.host_busy_reason()
