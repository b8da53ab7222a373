"""
The port's data layer against the JAX package's, on the same files and
seeded numpy inputs: PDB reading and featurization on data/1CRN.pdb,
7PFL.pdb, 7ZYA.pdb and synthetic PDBs (within 1e-9, NaN padding included);
the dataset splits, means and stacked arrays for leftalign and randomcrop
(float32 arrays within 1e-6: the JAX package may featurize with its C++
path, equal to its Python path within 1e-9), the per-epoch re-crop; the
host helpers; corrupt_batch; and the device NeRF, values and gradients,
within 1e-4 / rtol 1e-4 in float32 over a 20-residue chain.
"""
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foldingdiff_tpu import utils as jax_utils
from foldingdiff_tpu.data import datasets as jax_dsets
from foldingdiff_tpu.diffusion import noise as jax_noise
from foldingdiff_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from foldingdiff_tpu.geometry import featurize as jax_featurize
from foldingdiff_tpu.geometry import nerf as jax_nerf
from foldingdiff_tpu.geometry import pdb as jax_pdb
from foldingdiff_tpu.ops import angles as jax_angles
from foldingdiff_tpu_torch import utils
from foldingdiff_tpu_torch.data import datasets as dsets
from foldingdiff_tpu_torch.diffusion.noise import corrupt_batch
from foldingdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from foldingdiff_tpu_torch.geometry import featurize, nerf, pdb
from foldingdiff_tpu_torch.ops import angles
from tests.helpers import DATA_DIR, make_synthetic_pdb_dir

FIXTURES = [os.path.join(DATA_DIR, f) for f in ("1CRN.pdb", "7PFL.pdb", "7ZYA.pdb")]


@pytest.fixture(scope="module")
def synthetic_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synth_pdbs"))
    make_synthetic_pdb_dir(d, n=20, seed=5, min_len=25)
    return d


def _all_pdbs(synthetic_dir):
    return FIXTURES + sorted(glob.glob(os.path.join(synthetic_dir, "*.pdb")))[:4]


def test_read_pdb_matches_jax(synthetic_dir):
    for fname in _all_pdbs(synthetic_dir):
        ours, ref = pdb.read_pdb(fname), jax_pdb.read_pdb(fname)
        assert ours.model_count == ref.model_count
        assert [(a.name, a.res_name, a.res_id, a.chain_id, a.altloc) for a in ours.atoms] == \
            [(a.name, a.res_name, a.res_id, a.chain_id, a.altloc) for a in ref.atoms]
        np.testing.assert_array_equal(ours.backbone_coords(), ref.backbone_coords())
        np.testing.assert_array_equal(pdb.extract_backbone_coords(fname), jax_pdb.extract_backbone_coords(fname))
        assert pdb.get_pdb_length(fname) == jax_pdb.get_pdb_length(fname)
        assert pdb.get_model_count(fname) == jax_pdb.get_model_count(fname)
    het = pdb.read_pdb(FIXTURES[1], keep_hetero=True)
    assert len(het.atoms) == len(jax_pdb.read_pdb(FIXTURES[1], keep_hetero=True).atoms) > len(
        pdb.read_pdb(FIXTURES[1]).atoms)


@pytest.mark.parametrize("features", ["exhaustive", "minimal"])
def test_canonical_features_match_jax(synthetic_dir, features):
    dists, angs = ((featurize.EXHAUSTIVE_DISTS, featurize.EXHAUSTIVE_ANGLES) if features == "exhaustive"
                   else (featurize.MINIMAL_DISTS, featurize.MINIMAL_ANGLES))
    for fname in _all_pdbs(synthetic_dir):
        values, names = featurize.canonical_distances_and_dihedrals(fname, distances=dists, angles=angs)
        ref = jax_featurize.canonical_distances_and_dihedrals(fname, distances=dists, angles=angs)
        assert names == list(ref.columns)
        assert values.dtype == np.float64 and values.shape == ref.shape
        np.testing.assert_allclose(values, ref.values, atol=1e-9, rtol=0, equal_nan=True)
        assert np.isnan(values[0, names.index("phi")]) and np.isnan(values[-1, names.index("psi")])
        if features == "exhaustive":
            assert values[-1, names.index("0C:1N")] == 0.0 and np.isnan(values[-1, names.index("tau")])


def test_featurize_skips_what_jax_skips(tmp_path):
    with open(FIXTURES[0]) as f:
        atoms = [line for line in f if line.startswith("ATOM")]
    multi = tmp_path / "two_models.pdb"
    multi.write_text("MODEL        1\n" + "".join(atoms) + "ENDMDL\nMODEL        2\n" + "".join(atoms) + "ENDMDL\nEND\n")
    short = tmp_path / "one_residue.pdb"
    short.write_text("".join(atoms[:4]) + "END\n")
    for fname in (str(multi), str(short)):
        assert featurize.canonical_distances_and_dihedrals(fname) is None
        assert jax_featurize.canonical_distances_and_dihedrals(fname) is None
    assert pdb.get_pdb_length(str(multi)) == jax_pdb.get_pdb_length(str(multi)) == -1
    assert pdb.extract_backbone_coords(str(multi)) is None


def test_host_helpers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-10, 10, (50, 4))
    x[3, 1] = np.nan
    np.testing.assert_array_equal(utils.modulo_with_wrapped_range(x), jax_utils.modulo_with_wrapped_range(x))
    np.testing.assert_array_equal(utils.wrapped_mean(x, axis=0), jax_utils.wrapped_mean(x, axis=0))
    assert utils.modulo_with_wrapped_range(3, -2, 2) == -1
    assert utils.tolerant_comparison_check(-3.1415927410125732, ">=", -np.pi)
    assert utils.tolerant_comparison_check(x[:, 0], "<=", 5.0) == jax_utils.tolerant_comparison_check(x[:, 0], "<=", 5.0)
    assert utils.update_dict_nonnull({"a": 1, "b": 2}, {"b": 3, "c": 4, "a": None}) == {"a": 1, "b": 3, "c": 4}
    xf = x.astype(np.float32)
    np.testing.assert_allclose(angles.wrapped_mean(torch.tensor(xf), dim=0).numpy(),
                               np.asarray(jax_angles.wrapped_mean_jnp(jnp.asarray(xf), axis=0)), atol=1e-6)
    a, b = xf[:, 0], xf[:, 2]
    np.testing.assert_allclose(angles.angular_difference(torch.tensor(a), torch.tensor(b)).numpy(),
                               np.asarray(jax_angles.angular_difference(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)


def _dataset_pair(cls_name, pdb_dir, tmp_path, **kw):
    """The port's and the JAX package's dataset of one class on the same
    files, each caching into its own directory."""
    os.makedirs(tmp_path / "c_ours", exist_ok=True)
    os.makedirs(tmp_path / "c_ref", exist_ok=True)
    ours = getattr(dsets, cls_name)(pdbs=pdb_dir, cache_dir=str(tmp_path / "c_ours"), n_workers=1, **kw)
    ref = getattr(jax_dsets, cls_name)(pdbs=pdb_dir, cache_dir=str(tmp_path / "c_ref"), n_workers=1, **kw)
    return ours, ref


@pytest.mark.parametrize("trim", ["leftalign", "randomcrop"])
@pytest.mark.parametrize("split", ["train", "validation", "test"])
def test_dataset_split_means_and_arrays_match_jax(synthetic_dir, tmp_path, trim, split):
    ours, ref = _dataset_pair("AnglesOnlyDataset", synthetic_dir, tmp_path, split=split, pad=32, min_length=26,
                              trim_strategy=trim)
    assert ours.filenames == ref.filenames and len(ours) > 0
    np.testing.assert_allclose(ours.means, ref.means, atol=1e-9, rtol=0)
    np.testing.assert_allclose(ours.get_masked_means(), ref.get_masked_means(), atol=1e-9, rtol=0)
    if split == "train":
        assert ours.over_pad_indices == ref.over_pad_indices and ours.over_pad_indices
    a, b = ours.to_arrays(), ref.to_arrays()
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("cls_name", ["AngleDataset", "MinimalAnglesDataset", "CoordsDataset"])
def test_other_feature_sets_match_jax(synthetic_dir, tmp_path, cls_name):
    ours, ref = _dataset_pair(cls_name, synthetic_dir, tmp_path, pad=40, min_length=0, trim_strategy="discard",
                              zero_center=cls_name != "CoordsDataset")
    assert ours.feature_names == ref.feature_names and len(ours) == len(ref)
    a, b = ours.to_arrays(), ref.to_arrays()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)


def test_refresh_crops_matches_jax_over_epochs(synthetic_dir, tmp_path):
    ours, ref = _dataset_pair("AnglesOnlyDataset", synthetic_dir, tmp_path, split="train", pad=30, min_length=0,
                              trim_strategy="randomcrop")
    a, b = ours.to_arrays(), ref.to_arrays()
    for epoch_seed in (42 * 1_000_003, 42 * 1_000_003 + 1, 7):
        before = a["angles"].copy()
        ours.refresh_crops_(a, epoch_seed=epoch_seed)
        ref.refresh_crops_(b, epoch_seed=epoch_seed)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)
        assert not np.array_equal(before, a["angles"])


def test_cache_is_the_ports_own(synthetic_dir, tmp_path):
    """The port writes cache_canonical_torch_* keyed on its own sources and
    neither opens nor deletes the JAX package's cache in the same directory."""
    cache = tmp_path / "shared"
    os.makedirs(cache)
    jax_dsets.AnglesOnlyDataset(pdbs=synthetic_dir, cache_dir=str(cache), n_workers=1, min_length=0)
    jax_cache = glob.glob(str(cache / "cache_canonical_structures_*.pkl"))
    assert len(jax_cache) == 1
    first = dsets.AnglesOnlyDataset(pdbs=synthetic_dir, cache_dir=str(cache), n_workers=1, min_length=0)
    ours = glob.glob(str(cache / f"{dsets.CACHE_PREFIX}_*.pkl"))
    assert ours == [first.cache_fname] and glob.glob(str(cache / "cache_canonical_structures_*.pkl")) == jax_cache
    with open(first.cache_fname, "rb") as f:
        _, structures = pickle.load(f)
    assert all(isinstance(s["angles"], np.ndarray) for s in structures)
    again = dsets.AnglesOnlyDataset(pdbs=synthetic_dir, cache_dir=str(cache), n_workers=1, min_length=0)
    np.testing.assert_array_equal(again.to_arrays()["angles"], first.to_arrays()["angles"])


def test_corrupt_batch_is_q_sample_of_its_draws():
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-np.pi, np.pi, (5, 12, 6)).astype(np.float32)
    is_angular = [True] * 3 + [False, True, True]
    sched = DiffusionSchedule.create("cosine", 50, device="cpu")
    out = corrupt_batch(torch.Generator().manual_seed(1), torch.tensor(x0), sched, is_angular, 1.0, 0.5)
    t, noise = out["t"].numpy(), out["known_noise"].numpy()
    assert t.shape == (5,) and t.min() >= 0 and t.max() < 50
    ref = jax_noise.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise), JaxSchedule.create("cosine", 50),
                             is_angular)
    np.testing.assert_allclose(out["corrupted"].numpy(), np.asarray(ref), atol=1e-6)
    assert sorted(out) == ["corrupted", "known_noise", "t"]
    again = corrupt_batch(torch.Generator().manual_seed(1), torch.tensor(x0), sched, is_angular, 1.0, 0.5)
    np.testing.assert_array_equal(again["known_noise"].numpy(), noise)


def _nerf_inputs(b=3, length=20, seed=4):
    rng = np.random.default_rng(seed)
    dihedrals = rng.uniform(-np.pi, np.pi, (3, b, length)).astype(np.float32)
    bond_angles = rng.normal([[[1.94]], [[2.03]], [[2.12]]], 0.05, (3, b, length)).astype(np.float32)
    return [*dihedrals, *bond_angles]


def test_nerf_build_batch_values_and_gradients_match_jax():
    args = _nerf_inputs()
    names = ["phi", "psi", "omega", "bond_angle_n_ca_c", "bond_angle_ca_c_n", "bond_angle_c_n_ca"]
    weights = np.random.default_rng(9).normal(size=(3, 60, 3)).astype(np.float32)

    tensors = [torch.tensor(a, requires_grad=True) for a in args]
    coords = nerf.nerf_build_batch(**dict(zip(names, tensors)))
    (coords * torch.tensor(weights)).sum().backward()

    def jax_fn(*xs):
        return jnp.sum(jax_nerf.nerf_build_batch(**dict(zip(names, xs))) * weights)

    ref = jax_nerf.nerf_build_batch(**dict(zip(names, map(jnp.asarray, args))))
    ref_grads = jax.grad(jax_fn, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    assert coords.shape == (3, 60, 3)
    np.testing.assert_allclose(coords.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)
    for name, t, g in zip(names, tensors, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-4, err_msg=name)


def test_nerf_build_batch_agrees_with_the_float64_build():
    """The tensor build in float64 is the host build item by item."""
    args = [a.astype(np.float64) for a in _nerf_inputs(b=2, length=15)]
    coords = nerf.nerf_build_batch(*map(torch.tensor, args)).numpy()
    for i in range(2):
        ref = nerf.nerf_build_np(args[0][i], args[1][i], args[2][i], args[3][i], args[4][i], args[5][i])
        np.testing.assert_allclose(coords[i], ref, atol=1e-10)
