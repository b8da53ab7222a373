"""
The port's host statistics (foldingdiff_tpu_torch/metrics/: kl.py,
clashes.py, ss.py) against the JAX package's on the same inputs, exactly:
the KS feature tests and the histogram KL on seeded numpy samples, the KL
of a noised dataset per timestep, and the clash counts, P-SEA labels and
secondary-structure element counts of data/1CRN.pdb, 7PFL.pdb, 7ZYA.pdb
and chains that the port's NeRF builds. The DSSP backend's case skips
without a DSSP binary on PATH.
"""
import os

import numpy as np
import pytest

from foldingdiff_tpu.data import datasets as jax_datasets
from foldingdiff_tpu.metrics import clashes as jax_clashes
from foldingdiff_tpu.metrics import kl as jax_kl
from foldingdiff_tpu.metrics import ss as jax_ss
from foldingdiff_tpu_torch.data import datasets as dsets
from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf
from foldingdiff_tpu_torch.metrics import clashes, kl, ss
from tests.helpers import DATA_DIR, make_synthetic_pdb_dir

FT_NAMES = ["phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA"]


@pytest.fixture(scope="module")
def pdbs(tmp_path_factory):
    """The three PDB fixtures, two helical and one random chain written by
    the port's NeRF (the random one clashes), and two perturbed 1CRN chains."""
    d = tmp_path_factory.mktemp("chains")
    rng = np.random.default_rng(0)
    chains = {
        "helix": np.tile([-1.0, -0.8, np.pi, 1.94, 2.03, 2.12], (60, 1)),
        "strand": np.tile([-2.4, 2.3, np.pi, 1.94, 2.03, 2.12], (40, 1)),
        "random": np.column_stack([rng.uniform(-np.pi, np.pi, (80, 3)), rng.uniform(1.7, 2.3, (80, 3))]),
    }
    files = [os.path.join(DATA_DIR, f) for f in ("1CRN.pdb", "7PFL.pdb", "7ZYA.pdb")]
    for name, angles in chains.items():
        files.append(create_new_chain_nerf(str(d / f"{name}.pdb"), angles, FT_NAMES))
        assert files[-1]
    files += make_synthetic_pdb_dir(str(d / "synth"), n=2, seed=1, min_len=30)
    return files


def test_ks_feature_tests_and_kl_equal_jax():
    rng = np.random.default_rng(0)
    gen = rng.normal(size=(700, 3))
    ref = rng.normal(loc=0.1, size=(900, 3))
    names = ["phi", "psi", "omega"]
    for kw in ({}, {"subsample": 100, "seed": 3, "alpha": 0.05}):
        assert kl.ks_feature_tests(gen, ref, names, **kw) == jax_kl.ks_feature_tests(gen, ref, names, **kw)
    for pseudocount in (False, True):
        for u, v in ((gen[:, 0], ref[:, 0]), (gen[:, 1], gen[:, 1]), (gen[:, 2] + 5, ref[:, 2])):
            assert kl.kl_from_empirical(u, v, pseudocount=pseudocount) == \
                jax_kl.kl_from_empirical(u, v, pseudocount=pseudocount)


def test_kl_from_dset_equals_jax(tmp_path):
    make_synthetic_pdb_dir(str(tmp_path / "pdbs"), n=6, seed=2, min_len=30)
    clean = dsets.AnglesOnlyDataset(pdbs=str(tmp_path / "pdbs"), pad=48, min_length=0, n_workers=1,
                                    cache_dir=str(tmp_path))
    kw = dict(timesteps=4, beta_schedule="cosine", angular_variance=0.8)
    got = kl.kl_from_dset(dsets.NoisedAnglesDataset(clean, **kw), seed=1, max_rows=100)
    want = jax_kl.kl_from_dset(jax_datasets.NoisedAnglesDataset(clean, **kw), seed=1, max_rows=100)
    assert got.shape == (4, 6)
    np.testing.assert_array_equal(got, want)


def test_clashes_equal_jax(pdbs):
    counts = [clashes.count_clashes(f) for f in pdbs]
    assert counts == [jax_clashes.count_clashes(f) for f in pdbs]
    assert counts[5] > 0  # the random chain clashes
    assert [clashes.count_clashes(f, alpha=0.9) for f in pdbs] == [jax_clashes.count_clashes(f, alpha=0.9) for f in pdbs]
    assert clashes.count_clashes_parallel(pdbs, nthreads=1) == jax_clashes.count_clashes_parallel(pdbs, nthreads=1)


def test_secondary_structure_equals_jax(pdbs):
    for f in pdbs:
        np.testing.assert_array_equal(ss.annotate_pdb_sse(f), jax_ss.annotate_pdb_sse(f), err_msg=f)
    counts = [ss.count_structures_in_pdb(f) for f in pdbs]
    assert counts == [jax_ss.count_structures_in_pdb(f) for f in pdbs]
    assert counts[3][0] >= 1 and counts[4][1] >= 1  # the helix and the strand are found
    assert ss.count_structures_in_pdb("no_such.pdb") == (-1, -1) == jax_ss.count_structures_in_pdb("no_such.pdb")
    assert ss.count_structures_parallel(pdbs, threads=1) == jax_ss.count_structures_parallel(pdbs, threads=1)


@pytest.mark.skipif(not ss.dssp_available(), reason="no mkdssp or dssp binary on PATH")
def test_dssp_backend_equals_jax(pdbs):
    for f in pdbs:
        assert ss.count_structures_in_pdb(f, backend="dssp") == jax_ss.count_structures_in_pdb(f, backend="dssp")
