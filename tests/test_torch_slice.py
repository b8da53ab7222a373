"""
The port's sampling slice end to end on the CPU: bin/sample_torch.py over the
mini fixture (DDPM, DPM-Solver++, --noise-scale and its errors) and over a
cart-coords model (CA-trace PDBs), the NeRF + PDB and CA-trace writers
against the JAX package's byte for byte, the import boundary (the port
imports nothing of the JAX package; the slice loads neither jax, flax,
pandas, matplotlib nor scipy), and the entry points' default device (the
card).
"""
import gzip
import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

import torch

from foldingdiff_tpu.geometry.featurize import create_new_chain_nerf as jax_create_new_chain_nerf
from foldingdiff_tpu.geometry.pdb import write_ca_trace_to_pdb as jax_write_ca_trace_to_pdb
from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf
from foldingdiff_tpu_torch.models import io as model_io
from foldingdiff_tpu_torch.models.config import ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_FIXTURE = os.path.join(REPO, "tests", "mini_model_for_testing", "results")
FT_NAMES = ["phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these eager loops run many tiny ops, which a
    thread pool slows down, the more so on cores that other test workers
    share."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _run(args, env=None):
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}  # one intra-op thread, as above
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)


def _check_outputs(out_dir, lengths):
    for i, length in enumerate(lengths):
        with gzip.open(out_dir / "sampled_angles" / f"generated_{i}.csv.gz", "rt") as f:
            assert f.readline().strip() == ",".join(FT_NAMES)
        angles = np.loadtxt(out_dir / "sampled_angles" / f"generated_{i}.csv.gz", delimiter=",", skiprows=1)
        assert angles.shape == (length, 6) and np.all(np.isfinite(angles))
        assert angles.min() >= -np.pi and angles.max() < np.pi
        lines = (out_dir / "sampled_pdb" / f"generated_{i}.pdb").read_text().splitlines()
        assert sum(line.startswith("ATOM") for line in lines) == 3 * length and lines[-1] == "END"
    assert len(os.listdir(out_dir / "sampled_pdb")) == len(lengths)


def test_sample_torch_cli_writes_csvs_and_pdbs(tmp_path):
    proc = _run(["bin/sample_torch.py", "-m", MINI_FIXTURE, "--device", "cpu", "-n", "1", "-l", "50", "53",
                 "-b", "4", "-o", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    _check_outputs(tmp_path, [50, 51, 52])


def test_sample_torch_cli_dpmpp(tmp_path):
    proc = _run(["bin/sample_torch.py", "-m", MINI_FIXTURE, "--device", "cpu", "--method", "dpmpp",
                 "--ddim_steps", "3", "-n", "1", "-l", "50", "53", "-b", "4", "-o", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    _check_outputs(tmp_path, [50, 51, 52])


def _cli():
    spec = importlib.util.spec_from_file_location("sample_torch", os.path.join(REPO, "bin", "sample_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sample_torch_cli_noise_scale(tmp_path):
    """One value or one per feature is a DDPM temperature; other counts, and
    any value with another method, exit with bin/sample.py's messages."""
    base = ["-m", MINI_FIXTURE, "--device", "cpu", "-n", "1", "-l", "50", "52", "-b", "2", "--nopdb"]
    cli = _cli()
    runs = {scale: cli.main([*base, "-o", str(tmp_path / str(i)), "--noise-scale", scale])
            for i, scale in enumerate(["1.0", "1.3", "0.5,1,1.5,2,1,0.8"])}
    assert all(r["n_structures"] == 2 for r in runs.values())
    a, b = (np.loadtxt(tmp_path / i / "sampled_angles" / "generated_0.csv.gz", delimiter=",", skiprows=1)
            for i in ("0", "1"))
    assert not np.allclose(a, b)  # the same seed, another temperature
    with pytest.raises(SystemExit, match="needs 1 or 6 values, got 2"):
        cli.main([*base, "-o", str(tmp_path / "x"), "--noise-scale", "1,2"])
    for method in ("ddim", "dpmpp"):
        with pytest.raises(SystemExit, match=f"method='{method}' takes none"):
            cli.main([*base, "-o", str(tmp_path / "y"), "--method", method, "--noise-scale", "1.1"])
    assert not (tmp_path / "y").exists()


def test_sample_torch_cli_without_cuda_fails_fast(tmp_path):
    proc = _run(["bin/sample_torch.py", "-m", MINI_FIXTURE, "-o", str(tmp_path)],
                env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "sampled_angles").exists()


def test_create_new_chain_nerf_pdb_is_byte_identical(tmp_path):
    rng = np.random.default_rng(8)
    length = 40
    angles = np.column_stack([
        rng.uniform(-np.pi, np.pi, (length, 3)),
        rng.normal([1.94, 2.03, 2.12], 0.05, (length, 3)),  # bond angles near their ideal values
    ])
    ours = create_new_chain_nerf(str(tmp_path / "ours.pdb"), angles, FT_NAMES)
    ref = jax_create_new_chain_nerf(str(tmp_path / "ref.pdb"), pd.DataFrame(angles, columns=FT_NAMES))
    assert ours and ref
    assert (tmp_path / "ours.pdb").read_bytes() == (tmp_path / "ref.pdb").read_bytes()


def _cart_coords_dir(path, decoder_scale=1.0):
    """A 1-layer cart-coords model directory (x, y, z features, linear T = 10)
    with seeded random weights, its decoder's output weights times
    decoder_scale."""
    config = ModelConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=32, ft_is_angular=(False,) * 3, ft_names=("x", "y", "z"))
    state = model_io.init_random(config, torch.Generator().manual_seed(0)).state_dict()
    state["token_decoder.dense2.weight"] = state["token_decoder.dense2.weight"] * decoder_scale
    train_args = {"angles_definitions": "cart-coords", "max_seq_len": 32, "timesteps": 10,
                  "variance_schedule": "linear", "num_hidden_layers": 1, "hidden_size": 32, "intermediate_size": 64,
                  "num_heads": 2, "position_embedding_type": "relative_key"}
    model_io.save_model_dir(str(path), config, state, train_args)
    return str(path)


def test_sample_torch_cli_writes_ca_traces_for_cart_coords(tmp_path, caplog):
    """A cart-coords model samples to CA-trace PDBs whose ATOM lines are the
    JAX package's write_ca_trace_to_pdb's on the same coordinates; a trace
    that overflows the PDB columns (decoder weights x 1e6) is skipped with a
    warning."""
    model_dir = _cart_coords_dir(tmp_path / "model")
    out = tmp_path / "out"
    result = _cli().main(["-m", model_dir, "--device", "cpu", "-n", "1", "-l", "20", "23", "-b", "4", "-o", str(out)])
    assert result["n_structures"] == 3 and result["pdb_skipped"] == [] and len(result["pdb_files"]) == 3
    for i, length in enumerate([20, 21, 22]):
        csv_file = out / "sampled_angles" / f"generated_{i}.csv.gz"
        with gzip.open(csv_file, "rt") as f:
            assert f.readline().strip() == "x,y,z"
        coords = np.loadtxt(csv_file, delimiter=",", skiprows=1)
        assert coords.shape == (length, 3) and np.all(np.isfinite(coords))
        ref = jax_write_ca_trace_to_pdb(coords, str(tmp_path / f"ref_{i}.pdb"))
        ours = (out / "sampled_pdb" / f"generated_{i}.pdb").read_bytes()
        assert ours == (tmp_path / f"ref_{i}.pdb").read_bytes() and ref
        lines = ours.decode().splitlines()
        assert sum(line.startswith("ATOM") and line[12:16] == " CA " for line in lines) == length

    wild = _cart_coords_dir(tmp_path / "wild", decoder_scale=1e6)
    with caplog.at_level("WARNING"):
        result = _cli().main(["-m", wild, "--device", "cpu", "-n", "1", "-l", "20", "22", "-b", "4",
                              "-o", str(tmp_path / "wild_out")])
    assert result["pdb_skipped"] == [0, 1] and result["pdb_files"] == []
    assert sum("Skipping sample" in r.getMessage() and "column width" in r.getMessage() for r in caplog.records) == 2
    assert os.listdir(tmp_path / "wild_out" / "sampled_pdb") == []


def test_port_imports_nothing_of_the_jax_package():
    """With foldingdiff_tpu, jax and flax refused by an import hook, every
    module of the port, the module-level imports of chip_smoke.py, of the 17
    CLIs (bin/*_torch.py) and of the two examples (examples/*_torch.py),
    from_dir, AnglesEmptyDataset.from_dir, an epoch of Trainer.fit, one
    pre-corrupted step, one ARTrainer step, one ar_sample and one
    data-parallel step in a process group (parallel/) all work, and load
    neither optax nor pandas."""
    script = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("foldingdiff_tpu", "jax", "flax"):
                    raise ModuleNotFoundError(f"refused: {{name}}")
                return None

        sys.meta_path.insert(0, Refuse())
        import foldingdiff_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(foldingdiff_tpu_torch.__path__, "foldingdiff_tpu_torch.")]
        assert {{"foldingdiff_tpu_torch.parallel.mesh", "foldingdiff_tpu_torch.parallel.multihost",
                 "foldingdiff_tpu_torch.parallel.tp"}} <= set(names)
        for name in names:
            importlib.import_module(name)
        import glob, os
        scripts = ["chip_smoke.py", *sorted(glob.glob("bin/*_torch.py")), *sorted(glob.glob("examples/*_torch.py"))]
        assert len(scripts) == 20, scripts  # chip_smoke.py, 17 CLIs, 2 examples
        for path in scripts:
            name = os.path.splitext(os.path.basename(path))[0]
            spec = importlib.util.spec_from_file_location(name, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        from foldingdiff_tpu_torch.data.datasets import AnglesEmptyDataset
        from foldingdiff_tpu_torch.models.io import from_dir

        model, args = from_dir({MINI_FIXTURE!r}, device="cpu")
        empty = AnglesEmptyDataset.from_dir({MINI_FIXTURE!r})
        assert model.config.hidden_size == args["hidden_size"] and empty.pad == args["max_seq_len"]

        import numpy as np
        import torch
        from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
        from foldingdiff_tpu_torch.training.trainer import Trainer, TrainConfig
        rng = np.random.default_rng(0)
        data = {{"angles": rng.uniform(-3, 3, (6, 64, 6)).astype(np.float32),
                 "attn_mask": np.ones((6, 64), np.float32), "lengths": np.full(6, 64)}}
        trainer = Trainer(model, DiffusionSchedule.create("cosine", 10, device="cpu"),
                          TrainConfig(batch_size=4, max_epochs=1, use_pdist_loss=0.5), steps_per_epoch=2)
        assert len(trainer.fit(data, valid_data=data)) == 1
        batch = {{"corrupted": torch.from_numpy(data["angles"][:4]), "t": torch.full((4, 1), 3),
                  "known_noise": torch.from_numpy(data["angles"][:4]), "attn_mask": torch.ones(4, 64)}}
        assert torch.isfinite(trainer.train_step_precorrupted(batch)[0])
        from foldingdiff_tpu_torch.models.ar import BertForAutoregressive, ar_sample
        from foldingdiff_tpu_torch.training.ar_trainer import ARTrainer
        ar, _ = from_dir({MINI_FIXTURE!r}, device="cpu", model_cls=BertForAutoregressive)
        ar_trainer = ARTrainer(ar, TrainConfig(batch_size=4, max_epochs=1), steps_per_epoch=1)
        assert torch.isfinite(ar_trainer.train_step(ar_trainer.to_device({{k: v[:4] for k, v in data.items()}})))
        assert ar_sample(ar, torch.from_numpy(data["angles"][:2]), torch.tensor([20, 9]), num_seed=4).shape == (2, 64, 6)
        import math, tempfile
        from foldingdiff_tpu_torch.parallel import multihost
        with tempfile.TemporaryDirectory() as d:
            multihost.initialize(f"file://{{d}}/store", 1, 0, device="cpu")
            assert math.isfinite(multihost.dp_train_step_demo(device="cpu"))
            multihost.shutdown()
        print(len(names), sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("foldingdiff_tpu", "jax", "flax", "optax", "pandas")))
    """)
    proc = _run(["-c", script])
    assert proc.returncode == 0, proc.stderr
    n_modules, loaded = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n_modules) >= 47 and loaded == "[]"


def test_entry_points_default_to_the_card(monkeypatch):
    """from_dir, DiffusionSchedule.create and multihost.dp_train_step_demo
    run on the card unless asked for the CPU: without one, the default
    raises at once, with the CLI's message; nothing falls back."""
    from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from foldingdiff_tpu_torch.models import io as model_io
    from foldingdiff_tpu_torch.parallel import multihost

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device cuda: no CUDA device is available"):
        model_io.from_dir(MINI_FIXTURE)
    with pytest.raises(RuntimeError, match="device cuda: no CUDA device is available"):
        DiffusionSchedule.create("cosine", 10)
    with pytest.raises(RuntimeError, match="device cuda:1: no CUDA device"):
        DiffusionSchedule.create("cosine", 10, device="cuda:1")
    with pytest.raises(RuntimeError, match="device cuda: no CUDA device is available"):
        multihost.dp_train_step_demo()
    assert DiffusionSchedule.create("cosine", 10, device="cpu").betas.device.type == "cpu"


def test_slice_imports_no_jax_flax_pandas_or_matplotlib():
    """Sampling, partial-noise reconstruction with its TM scoring, a debug
    noiser's item and the three CLIs' modules load none of jax, flax,
    pandas, matplotlib or scipy (the card's machine has none but scipy).
    Then, with jax, flax, pandas, matplotlib, PIL and sklearn refused by an
    import hook, every module of the port imports, and the number paths --
    bin/sample_torch.py's report with --testcomparison, lDDT, scTM,
    tmscore_training and hclust's JSON and matrix -- write every number
    and load none of them."""
    script = textwrap.dedent(f"""
        import importlib.util, sys
        import numpy as np
        import torch
        from foldingdiff_tpu_torch.data.datasets import AnglesEmptyDataset
        from foldingdiff_tpu_torch.data.debug_noisers import SingleNoisedAngleDataset
        from foldingdiff_tpu_torch.diffusion.sampling import get_reconstruction_error, sample
        from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
        from foldingdiff_tpu_torch.eval import tmscore
        from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf
        from foldingdiff_tpu_torch.models import io
        from foldingdiff_tpu_torch.training import orchestration

        for name in ("sample_torch", "train_torch", "partial_noise_reconstruct_torch"):
            spec = importlib.util.spec_from_file_location(name, f"bin/{{name}}.py")
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        model, args = io.from_dir({MINI_FIXTURE!r}, device="cpu")
        empty = AnglesEmptyDataset.from_dir({MINI_FIXTURE!r})
        schedule = DiffusionSchedule.create("cosine", 2, device="cpu")
        out = sample(model, schedule, is_angular=empty.feature_is_angular["angles"], pad=empty.pad, lengths=[20])
        assert out[0].shape == (20, 6)
        import tempfile, os
        with tempfile.TemporaryDirectory() as d:
            assert create_new_chain_nerf(os.path.join(d, "x.pdb"), out[0], empty.feature_names["angles"])
        data = {{"angles": np.concatenate([out[0], np.zeros((44, 6), np.float32)])[None],
                 "attn_mask": (np.arange(64) < 20).astype(np.float32)[None], "lengths": np.array([20])}}
        recon = get_reconstruction_error(model, DiffusionSchedule.create("linear", 10, device="cpu"), data,
                                         is_angular=[True] * 6, noise_timesteps=1)
        score, score_coord = tmscore.score_reconstruction(recon[0], out[0], "data/1CRN.pdb", empty.feature_names["angles"])
        assert 0.5 < score <= 1 and 0 < score_coord <= 1

        class Clean:
            feature_names, feature_is_angular, pad = empty.feature_names, empty.feature_is_angular, 64
            def __len__(self):
                return 1
            def __getitem__(self, i, ignore_zero_center=False):
                return {{k: v[0] for k, v in data.items()}}
        assert SingleNoisedAngleDataset(dset=Clean(), seed=0)[0]["corrupted"].shape == (64, 1)
        print(sorted(m for m in ("jax", "flax", "pandas", "matplotlib", "scipy") if m in sys.modules))

        # The number paths of the evaluation and the report, with the
        # packages the card's machine lacks refused: every number is written
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "flax", "pandas", "matplotlib", "PIL", "sklearn"):
                    raise ModuleNotFoundError(f"refused: {{name}}", name=name)
                return None

        sys.meta_path.insert(0, Refuse())
        import json, pkgutil
        import foldingdiff_tpu_torch
        for m in pkgutil.walk_packages(foldingdiff_tpu_torch.__path__, "foldingdiff_tpu_torch."):
            importlib.import_module(m.name)
        from examples.synthetic_proteins_torch import make_synthetic_protein_dir
        from foldingdiff_tpu_torch.geometry.pdb import extract_backbone_coords, write_coords_to_pdb

        def cli(name, argv):
            spec = importlib.util.spec_from_file_location(name, f"bin/{{name}}.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.main(argv)

        with tempfile.TemporaryDirectory() as d:
            os.environ["FOLDINGDIFF_CACHE_DIR"] = d
            corpus = os.path.join(d, "corpus")
            make_synthetic_protein_dir(corpus, n=16, min_len=40, max_len=60, seed=1)
            report = cli("sample_torch", ["-m", {MINI_FIXTURE!r}, "--cpu", "-n", "1", "-l", "40", "43", "-b", "4",
                                          "--method", "ddim", "--ddim_steps", "5", "-o", os.path.join(d, "s"),
                                          "--testcomparison", corpus])["report"]
            assert sorted(report) == ["ks_tests.json", "ss_counts.json"], report
            sampled, folded = os.path.join(d, "s", "sampled_pdb"), os.path.join(d, "folded")
            os.makedirs(folded)
            rng = np.random.default_rng(0)
            for i in range(3):
                bb = extract_backbone_coords(os.path.join(sampled, f"generated_{{i}}.pdb"), atoms=("N", "CA", "C"))
                write_coords_to_pdb(bb + rng.normal(scale=0.3, size=bb.shape),
                                    os.path.join(folded, f"generated_{{i}}_0_residues_x.pdb"))
            assert len(cli("lddt_torch", [sampled, folded, "-o", os.path.join(d, "lddt.json")])) == 3
            assert len(cli("sctm_torch", ["-p", sampled, "-f", folded, "-o", os.path.join(d, "sctm")])) == 3
            assert len(cli("tmscore_training_torch", ["-d", sampled, "--trainfiles", corpus])) == 3
            hclust = cli("hclust_structures_torch", [folded, "-o", os.path.join(d, "hc"), "--nclusters", "2"])
            assert len(hclust["clusters"]) == 3
            written = (sorted(f for f in os.listdir(d) if "." in f and not f.startswith("cache_"))
                       + sorted(os.listdir(os.path.join(d, "s", "plots"))))
            assert written == ["hc_clusters.json", "hc_tm_matrix.npy", "lddt.json", "sctm.csv", "sctm.json",
                               "sctm_refs.json", "ks_tests.json", "ss_counts.json"], written
        print(sorted(m for m in ("jax", "flax", "pandas", "matplotlib", "PIL", "sklearn") if m in sys.modules))
    """)
    proc = _run(["-c", script])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-2:] == ["[]", "[]"]
