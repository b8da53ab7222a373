"""
The port's sampling slice end to end on the CPU: bin/sample_torch.py over the
mini fixture, the NeRF + PDB writer against the JAX package's byte for byte,
and the import boundary (the slice loads neither jax, flax, pandas nor
matplotlib).
"""
import gzip
import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd

from foldingdiff_tpu.geometry.featurize import create_new_chain_nerf as jax_create_new_chain_nerf
from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_FIXTURE = os.path.join(REPO, "tests", "mini_model_for_testing", "results")
FT_NAMES = ["phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA"]


def _run(args, **kw):
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True, timeout=300, **kw)


def test_sample_torch_cli_writes_csvs_and_pdbs(tmp_path):
    proc = _run(["bin/sample_torch.py", "-m", MINI_FIXTURE, "--device", "cpu", "-n", "1", "-l", "50", "53",
                 "-b", "4", "-o", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    for i, length in enumerate([50, 51, 52]):
        with gzip.open(tmp_path / "sampled_angles" / f"generated_{i}.csv.gz", "rt") as f:
            assert f.readline().strip() == ",".join(FT_NAMES)
        angles = np.loadtxt(tmp_path / "sampled_angles" / f"generated_{i}.csv.gz", delimiter=",", skiprows=1)
        assert angles.shape == (length, 6) and np.all(np.isfinite(angles))
        assert angles.min() >= -np.pi and angles.max() < np.pi
        lines = (tmp_path / "sampled_pdb" / f"generated_{i}.pdb").read_text().splitlines()
        assert sum(line.startswith("ATOM") for line in lines) == 3 * length and lines[-1] == "END"
    assert len(os.listdir(tmp_path / "sampled_pdb")) == 3


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


def test_slice_imports_no_jax_flax_pandas_or_matplotlib():
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        from foldingdiff_tpu_torch.data.datasets import AnglesEmptyDataset
        from foldingdiff_tpu_torch.diffusion.sampling import sample
        from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
        from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf
        from foldingdiff_tpu_torch.models import io

        model, args = io.from_dir({MINI_FIXTURE!r})
        empty = AnglesEmptyDataset.from_dir({MINI_FIXTURE!r})
        out = sample(model, DiffusionSchedule.create("cosine", 2), is_angular=empty.feature_is_angular["angles"],
                     pad=empty.pad, lengths=[20], mean_offset=empty.get_masked_means())
        assert out[0].shape == (20, 6)
        import tempfile, os
        with tempfile.TemporaryDirectory() as d:
            assert create_new_chain_nerf(os.path.join(d, "x.pdb"), out[0], empty.feature_names["angles"])
        print(sorted(m for m in ("jax", "flax", "pandas", "matplotlib") if m in sys.modules))
    """)
    proc = _run(["-c", script])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
