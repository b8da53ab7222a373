"""
The port's evaluation surface against the JAX package's on the CPU, on the
same files and numpy inputs: lDDT (lddt_np, the batched lddt_torch against
lddt_jax, the file and directory APIs), the evaluation CLIs (bin/*_torch.py
against bin/*.py, called in this process with their arguments), side chains
and backbone oxygens, and the native featurizer's binding.
"""
import importlib.util
import json
import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.synthetic_proteins_torch import synth_angles
from foldingdiff_tpu.data import featurize_native as jax_featurize_native
from foldingdiff_tpu.geometry import sidechains as jax_sidechains
from foldingdiff_tpu.metrics import lddt as jax_lddt
from foldingdiff_tpu_torch.data import featurize_native
from foldingdiff_tpu_torch.geometry import featurize, sidechains
from foldingdiff_tpu_torch.geometry.pdb import extract_backbone_coords, read_pdb, write_coords_to_pdb
from foldingdiff_tpu_torch.metrics import lddt
from tests.tmalign_bindings import assert_both_loaded, jax_tmalign  # noqa: F401 (jax_tmalign: a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
CRN = os.path.join(DATA, "1CRN.pdb")
FIXTURES = [os.path.join(DATA, f) for f in ("1CRN.pdb", "7PFL.pdb", "7ZYA.pdb")]


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"_eval_{name}", os.path.join(REPO, "bin", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_cli(name: str, argv, monkeypatch):
    """bin/<name>.py's main() in this process, serial (the JAX CLIs fork
    pools, which a process that has started JAX's threads must not do)."""
    module = load_script(name)
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [name, *argv])
        m.setattr(os, "cpu_count", lambda: 1)
        return module.main()


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """Three backbones from the port's NeRF (lengths 40, 52, 61), three
    jittered "refolds" of each named as the refold pipeline names them
    (N/CA/C moved by 0.3 (j + 1) A), and four training structures."""
    root = tmp_path_factory.mktemp("eval")
    sampled, folded, train = root / "sampled_pdb", root / "folded", root / "train"
    for d in (sampled, folded, train):
        d.mkdir()
    rng = np.random.default_rng(5)
    for i, length in enumerate((40, 52, 61)):
        out = featurize.create_new_chain_nerf(str(sampled / f"generated_{i}.pdb"), synth_angles(rng, length),
                                              featurize.EXHAUSTIVE_ANGLES)
        bb = extract_backbone_coords(out, atoms=("N", "CA", "C"))
        for j in range(3):
            write_coords_to_pdb(bb + rng.normal(scale=0.3 * (j + 1), size=bb.shape),
                                str(folded / f"generated_{i}_{j}_residues_test.pdb"))
    for i, length in enumerate((45, 50, 58, 66)):
        featurize.create_new_chain_nerf(str(train / f"train_{i}.pdb"), synth_angles(rng, length),
                                        featurize.EXHAUSTIVE_ANGLES)
    return root


# -- lDDT -------------------------------------------------------------------


def _coords(b: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    ref = np.cumsum(rng.normal(scale=2.2, size=(b, n, 3)), axis=1)  # a random walk: neighbours within 15 A
    return ref + rng.normal(scale=1.0, size=ref.shape), ref


def test_lddt_np_matches_jax():
    model, ref = _coords(1, 60, 0)
    ri = np.repeat(np.arange(20), 3)
    for kw in ({}, {"residue_index": ri}, {"residue_index": ri, "per_residue": True}, {"inclusion_radius": 8.0}):
        ours, theirs = lddt.lddt_np(model[0], ref[0], **kw), jax_lddt.lddt_np(model[0], ref[0], **kw)
        np.testing.assert_allclose(ours, theirs, atol=1e-12, rtol=0)
    assert 0 < lddt.lddt_np(model[0], ref[0]) < 1 and lddt.lddt_np(ref[0], ref[0]) == 1.0


@pytest.mark.parametrize("index", ["none", "per_atom", "per_batch"])
def test_lddt_torch_matches_lddt_jax_and_lddt_np(index):
    """B = 3, N = 60: float32 against lddt_jax within 1e-5, float64 against
    lddt_np within 1e-12; residue_index None, (N,) or (B, N)."""
    model, ref = _coords(3, 60, 1)
    rng = np.random.default_rng(2)
    ri = {"none": None, "per_atom": np.repeat(np.arange(20), 3),
          "per_batch": np.sort(rng.integers(0, 25, size=(3, 60)), axis=1)}[index]
    ours32 = lddt.lddt_torch(torch.from_numpy(model).float(), torch.from_numpy(ref).float(),
                             residue_index=None if ri is None else torch.from_numpy(ri))
    theirs = np.asarray(jax_lddt.lddt_jax(jnp.asarray(model, jnp.float32), jnp.asarray(ref, jnp.float32),
                                          residue_index=ri))
    assert ours32.dtype == torch.float32 and ours32.shape == (3,)
    np.testing.assert_allclose(ours32.numpy(), theirs, atol=1e-5, rtol=0)
    ours64 = lddt.lddt_torch(torch.from_numpy(model), torch.from_numpy(ref),
                             residue_index=None if ri is None else torch.from_numpy(ri))
    assert ours64.dtype == torch.float64
    for b in range(3):
        rib = None if ri is None else (ri if ri.ndim == 1 else ri[b])
        np.testing.assert_allclose(ours64[b].item(), lddt.lddt_np(model[b], ref[b], residue_index=rib),
                                   atol=1e-12, rtol=0)


def test_lddt_pdb_and_directories_match_jax(pipeline, tmp_path):
    """lddt_pdb on data/1CRN.pdb against jittered backbone copies (all
    atoms and CA only) and lddt_sampled_folded's JSON, against JAX's."""
    bb = extract_backbone_coords(CRN, atoms=("N", "CA", "C"))
    rng = np.random.default_rng(9)
    for j, scale in enumerate((0.0, 0.4, 1.5)):
        copy = write_coords_to_pdb(bb + rng.normal(scale=scale, size=bb.shape), str(tmp_path / f"crn_{j}.pdb"))
        for atoms in (lddt.BACKBONE_ATOM_NAMES, ("CA",)):
            ours, theirs = lddt.lddt_pdb(copy, CRN, atoms=atoms), jax_lddt.lddt_pdb(copy, CRN, atoms=atoms)
            assert abs(ours - theirs) <= 1e-12 and 0 < ours <= 1
    assert lddt.lddt_pdb(CRN, CRN) == 1.0 and lddt.lddt_pdb(str(tmp_path / "missing.pdb"), CRN) == -1.0

    ours = lddt.lddt_sampled_folded(pipeline / "sampled_pdb", pipeline / "folded", str(tmp_path / "ours.json"),
                                    threads=1)
    theirs = jax_lddt.lddt_sampled_folded(pipeline / "sampled_pdb", pipeline / "folded", str(tmp_path / "jax.json"),
                                          threads=1)
    assert json.loads((tmp_path / "ours.json").read_text()).keys() == theirs.keys() and len(theirs) == 3
    for stem, scores in theirs.items():
        assert ours[stem].keys() == scores.keys() and len(scores) == 3
        for k, v in scores.items():
            assert abs(ours[stem][k] - v) <= 1e-12


# -- the evaluation CLIs against JAX's ----------------------------------------


def test_lddt_cli_matches_jax(pipeline, tmp_path, monkeypatch):
    ours = load_script("lddt_torch").main([str(pipeline / "sampled_pdb"), str(pipeline / "folded"),
                                           "-o", str(tmp_path / "ours.json")])
    run_jax_cli("lddt", [str(pipeline / "sampled_pdb"), str(pipeline / "folded"), "-o", str(tmp_path / "jax.json")],
                monkeypatch)
    theirs = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "ours.json").read_text()) == ours
    for stem in theirs:
        np.testing.assert_allclose([ours[stem][k] for k in theirs[stem]], list(theirs[stem].values()), atol=1e-12)


def test_sctm_cli_matches_jax(pipeline, tmp_path, monkeypatch, jax_tmalign):
    """scores, refs and the CSV's numbers equal bin/sctm.py's, both on
    native TM-align."""
    assert_both_loaded(jax_tmalign)
    args = ["-p", str(pipeline / "sampled_pdb"), "-f", str(pipeline / "folded")]
    scores = load_script("sctm_torch").main([*args, "-o", str(tmp_path / "ours")])
    run_jax_cli("sctm", [*args, "-o", str(tmp_path / "jax")], monkeypatch)
    theirs = json.loads((tmp_path / "jax.json").read_text())
    assert scores.keys() == theirs.keys() and len(theirs) == 3
    np.testing.assert_allclose([scores[k] for k in theirs], list(theirs.values()), atol=1e-12)
    assert all(0.5 < v <= 1 for v in scores.values())
    assert json.loads((tmp_path / "ours_refs.json").read_text()) == json.loads((tmp_path / "jax_refs.json").read_text())
    ours_csv = np.genfromtxt(tmp_path / "ours.csv", delimiter=",", names=True, dtype=None, encoding=None)
    jax_csv = np.genfromtxt(tmp_path / "jax.csv", delimiter=",", names=True, dtype=None, encoding=None)
    assert ours_csv.dtype.names == jax_csv.dtype.names
    for name in ours_csv.dtype.names:
        if name == "sctm":
            np.testing.assert_allclose(ours_csv[name], jax_csv[name], atol=1e-12)
        else:
            assert list(ours_csv[name]) == list(jax_csv[name])
    assert (tmp_path / "ours_hist.pdf").stat().st_size > 0


def test_tmscore_training_cli_matches_jax(pipeline, tmp_path, monkeypatch, jax_tmalign):
    assert_both_loaded(jax_tmalign)
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    for name, out in (("tmscore_training_torch", "ours"), ("tmscore_training", "jax")):
        d = tmp_path / out
        d.mkdir()
        for f in (pipeline / "sampled_pdb").iterdir():
            (d / f.name).symlink_to(f)
        argv = ["-d", str(d), "--trainfiles", str(pipeline / "train"), "--train-subsample", "3"]
        if name.endswith("_torch"):
            load_script(name).main(argv)
        else:
            run_jax_cli(name, argv, monkeypatch)
    for fname in ("tm_scores.json", "tm_scores_ref.json"):
        ours, theirs = (json.loads((tmp_path / o / fname).read_text()) for o in ("ours", "jax"))
        assert ours.keys() == theirs.keys() and len(ours) == 3
        if fname == "tm_scores.json":
            np.testing.assert_allclose([ours[k] for k in theirs], list(theirs.values()), atol=1e-12)
        else:
            assert ours == theirs


def test_hclust_cli_matches_jax(pipeline, tmp_path, monkeypatch, jax_tmalign):
    assert_both_loaded(jax_tmalign)
    folded = str(pipeline / "folded")
    result = load_script("hclust_structures_torch").main([folded, "-o", str(tmp_path / "ours"), "--nclusters", "3"])
    run_jax_cli("hclust_structures", [folded, "-o", str(tmp_path / "jax"), "--nclusters", "3"], monkeypatch)
    ours, theirs = np.load(tmp_path / "ours_tm_matrix.npy"), np.load(tmp_path / "jax_tm_matrix.npy")
    assert ours.shape == (9, 9) and np.array_equal(result["tm_matrix"], ours)
    np.testing.assert_allclose(ours, theirs, atol=1e-12, rtol=0)
    np.testing.assert_array_equal(ours, ours.T)
    np.testing.assert_array_equal(np.diag(ours), np.ones(9))
    assert (json.loads((tmp_path / "ours_clusters.json").read_text())
            == json.loads((tmp_path / "jax_clusters.json").read_text()) == result["clusters"])
    assert (tmp_path / "ours_dendrogram.pdf").stat().st_size > 0


def test_annot_secondary_structures_cli_matches_jax(tmp_path, monkeypatch):
    pdbs = FIXTURES
    counts = load_script("annot_secondary_structures_torch").main(
        [*pdbs, str(tmp_path / "ours.pdf"), "--json", str(tmp_path / "ours.json")])
    run_jax_cli("annot_secondary_structures", [*pdbs, str(tmp_path / "jax.pdf"), "--json", str(tmp_path / "jax.json")],
                monkeypatch)
    ours = json.loads((tmp_path / "ours.json").read_text())
    assert ours == json.loads((tmp_path / "jax.json").read_text())
    assert ours == {"alpha": [a for a, _ in counts], "beta": [b for _, b in counts]} and sum(ours["alpha"]) > 0
    assert (tmp_path / "ours.pdf").stat().st_size > 0


def test_baseline_sctm_scores_setup_cli_matches_jax(tmp_path, monkeypatch):
    """The NeRF round trip of the test split of data/ (1CRN) is byte for
    byte JAX's."""
    monkeypatch.setenv("FOLDINGDIFF_CACHE_DIR", str(tmp_path))
    model = os.path.join(REPO, "tests", "mini_model_for_testing", "results")
    written = load_script("baseline_sctm_scores_setup_torch").main(
        ["-m", model, "--data", DATA, "-o", str(tmp_path / "ours")])
    run_jax_cli("baseline_sctm_scores_setup", ["-m", model, "--data", DATA, "-o", str(tmp_path / "jax")], monkeypatch)
    names = sorted(os.listdir(tmp_path / "jax" / "sampled_pdb"))
    assert names and sorted(os.path.basename(f) for f in written) == names
    for name in names:
        ours, theirs = (tmp_path / d / "sampled_pdb" / name for d in ("ours", "jax"))
        assert ours.read_bytes() == theirs.read_bytes()


def test_mds_cli_writes_the_embedding_and_figure(pipeline, tmp_path):
    emb = load_script("mds_structures_torch").main([str(pipeline / "folded"), "-o", str(tmp_path / "mds")])
    assert emb.shape == (9, 2) and np.all(np.isfinite(emb))
    np.testing.assert_array_equal(np.load(tmp_path / "mds_embedding.npy"), emb)
    assert (tmp_path / "mds.pdf").stat().st_size > 0


def test_figure_clis_write_non_empty_files(pipeline, tmp_path):
    """pdb_vis (PNG, PNG batch, GIF) and sample_plotting_only over a sample
    directory."""
    vis = load_script("pdb_vis_torch")
    pdbs = sorted(str(p) for p in (pipeline / "sampled_pdb").glob("*.pdb"))
    written = [vis.main(["pdb2png", pdbs[0], "-o", str(tmp_path / "one.png")]),
               *vis.main(["pdb2png_batch", *pdbs, "-o", str(tmp_path / "batch")]),
               vis.main(["pdb2gif", *pdbs[:2], "-o", str(tmp_path / "traj.gif")])]
    sampled = tmp_path / "sampled"
    (sampled / "sampled_angles").mkdir(parents=True)
    (sampled / "sampled_pdb").symlink_to(pipeline / "sampled_pdb")
    rng = np.random.default_rng(0)
    from foldingdiff_tpu_torch.utils import write_angles_csv

    for i in range(2):
        write_angles_csv(synth_angles(rng, 30), featurize.EXHAUSTIVE_ANGLES,
                         sampled / "sampled_angles" / f"generated_{i}.csv.gz")
    written += load_script("sample_plotting_only_torch").main(["-d", str(sampled)])
    assert len(written) == 9 and all(os.path.getsize(f) > 0 for f in written)
    assert json.loads((sampled / "plots" / "ss_counts.json").read_text()).keys() == {"alpha", "beta"}


# -- side chains and oxygens -------------------------------------------------


def test_add_oxygen_to_backbone_matches_jax_bytes(tmp_path):
    ours = sidechains.add_oxygen_to_backbone(CRN, str(tmp_path / "ours.pdb"))
    theirs = jax_sidechains.add_oxygen_to_backbone(CRN, str(tmp_path / "jax.pdb"))
    assert open(ours).read() == open(theirs).read()
    # on a pure N/CA/C backbone: one O per residue, after its C
    bb = write_coords_to_pdb(extract_backbone_coords(CRN, atoms=("N", "CA", "C")), str(tmp_path / "bb.pdb"))
    out = load_script("add_oxygen_to_backbone_torch").main([bb, "-o", str(tmp_path / "with_o")])
    names = [a.name for a in read_pdb(out[0]).atoms]
    assert names == ["N", "CA", "C", "O"] * 46
    assert open(out[0]).read() == open(jax_sidechains.add_oxygen_to_backbone(bb, str(tmp_path / "jax_o.pdb"))).read()


def test_add_sidechains_to_backbone_matches_jax_bytes(tmp_path):
    """1CRN's sequence grafted onto its own N/CA/C backbone: the ATOM lines
    of JAX's add_sidechains_to_backbone, byte for byte, with the side-chain
    atoms of every residue type the reference PDBs hold."""
    struct = read_pdb(CRN)
    seq = "".join(sidechains.AA_3TO1[a.res_name] for a in struct.atoms if a.name == "CA")
    bb = write_coords_to_pdb(extract_backbone_coords(CRN, atoms=("N", "CA", "C")), str(tmp_path / "bb.pdb"))
    ours = load_script("splice_aa_onto_backbone_torch").main([bb, seq, "-o", str(tmp_path / "ours.pdb")])
    theirs = jax_sidechains.add_sidechains_to_backbone(bb, seq, str(tmp_path / "jax.pdb"))
    assert open(ours).read() == open(theirs).read()
    atoms = read_pdb(ours).atoms
    library = sidechains.build_aa_sidechain_dict()
    assert len(atoms) == 3 * len(seq) + sum(len(library[aa]) for aa in seq)
    assert {"CB", "SG", "OG1"} <= {a.name for a in atoms}
    with pytest.raises(ValueError, match="residues in the sequence"):
        sidechains.add_sidechains_to_backbone(bb, seq + "A", str(tmp_path / "x.pdb"))


# -- the native featurizer ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_featurizer(tmp_path_factory):
    """The JAX package's featurizer binding, building and loading a copy of
    its library of its own in this process. Its _load builds in place at
    _SO_PATH and takes a file that exists as built, so a test process that
    loads the shared file while another one rebuilds it reads it half written
    ("file too short") and keeps that failure for the rest of its life."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_featurize_native, "_SO_PATH", str(tmp_path_factory.mktemp("jax_featurize") / "_featurize.so"))
        mp.setattr(jax_featurize_native, "_lib", None)
        mp.setattr(jax_featurize_native, "_tried", False)
        yield jax_featurize_native


@pytest.mark.parametrize("pdb_file", FIXTURES)
def test_native_featurizer_matches_jax_binding_and_numpy_path(pdb_file, jax_featurizer, caplog):
    with caplog.at_level(logging.WARNING):
        loaded = featurize_native.available(), jax_featurizer.available()
    assert all(loaded), f"native featurizer loaded (port, JAX): {loaded}; {caplog.text}"
    ours = featurize_native.featurize_pdb_native(pdb_file)
    theirs = jax_featurizer.featurize_pdb_native(pdb_file)
    np.testing.assert_array_equal(ours, theirs)
    values, names = featurize.canonical_distances_and_dihedrals(
        pdb_file, distances=featurize.EXHAUSTIVE_DISTS, angles=featurize.EXHAUSTIVE_ANGLES)
    assert names == featurize_native.COLUMNS and ours.shape == values.shape
    np.testing.assert_allclose(ours, values, atol=1e-9, rtol=0, equal_nan=True)


def test_native_featurizer_refuses_missing_and_gzipped_files(tmp_path):
    assert featurize_native.featurize_pdb_native(str(tmp_path / "nope.pdb")) is None
    assert featurize_native.featurize_pdb_native(str(tmp_path / "x.pdb.gz")) is None
    assert featurize_native.library_path().name.startswith("libfeaturize_")


# -- the synthetic corpus ------------------------------------------------------


def test_synthetic_corpus_generators_match_jax(tmp_path):
    """examples/synthetic_proteins_torch.py writes the JAX-side generator's
    files byte for byte from the same seed, CATH-scale lengths and the small
    set alike."""
    from examples import synthetic_proteins as jax_synth
    from examples import synthetic_proteins_torch as synth

    for make, kw in ((synth.make_cath_scale_corpus, {"n": 3, "seed": 4}),
                     (synth.make_synthetic_protein_dir, {"n": 3, "seed": 4})):
        ours = make(str(tmp_path / "ours" / make.__name__), **kw)
        theirs = getattr(jax_synth, make.__name__)(str(tmp_path / "jax" / make.__name__), **kw)
        assert [os.path.basename(f) for f in ours] == [os.path.basename(f) for f in theirs] and len(ours) == 3
        for a, b in zip(ours, theirs):
            assert open(a, "rb").read() == open(b, "rb").read()
