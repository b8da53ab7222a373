"""
Synthetic protein generator for the PyTorch port (the port's copy of
examples/synthetic_proteins.py): chains of alpha-helix, beta-strand and loop
segments with Ramachandran-plausible dihedrals, built into PDB files by the
port's NeRF (foldingdiff_tpu_torch.geometry.featurize.create_new_chain_nerf).
numpy only, so it runs where the JAX package cannot be imported; the same
seed writes the same files as the JAX-side generator.

Used by examples/run_synthetic_e2e_torch.py and chip_smoke.py.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

D = np.pi / 180.0

# Canonical dihedral regions (mean, std), radians
HELIX_PHI, HELIX_PSI = (-57 * D, 5 * D), (-47 * D, 5 * D)
SHEET_PHI, SHEET_PSI = (-120 * D, 10 * D), (125 * D, 10 * D)
TAU = (111 * D, 2 * D)
CA_C_N = (116 * D, 1.5 * D)
C_N_CA = (121.5 * D, 1.5 * D)


def synth_angles(rng: np.random.Generator, n_res: int) -> np.ndarray:
    """(n_res, 6) [phi, psi, omega, tau, CA:C:1N, C:1N:1CA] with segmental SS."""
    phi = np.empty(n_res)
    psi = np.empty(n_res)
    i = 0
    while i < n_res:
        kind = rng.choice(["helix", "sheet", "loop"], p=[0.45, 0.3, 0.25])
        seg = int(rng.integers(6, 14) if kind != "loop" else rng.integers(2, 6))
        seg = min(seg, n_res - i)
        if kind == "helix":
            phi[i : i + seg] = rng.normal(*HELIX_PHI, seg)
            psi[i : i + seg] = rng.normal(*HELIX_PSI, seg)
        elif kind == "sheet":
            phi[i : i + seg] = rng.normal(*SHEET_PHI, seg)
            psi[i : i + seg] = rng.normal(*SHEET_PSI, seg)
        else:
            phi[i : i + seg] = rng.uniform(-np.pi, 0, seg)
            psi[i : i + seg] = rng.uniform(-np.pi, np.pi, seg)
        i += seg
    omega = rng.normal(np.pi, 2 * D, n_res)  # trans peptide bonds
    omega = ((omega + np.pi) % (2 * np.pi)) - np.pi
    tau = rng.normal(*TAU, n_res)
    ca_c_n = rng.normal(*CA_C_N, n_res)
    c_n_ca = rng.normal(*C_N_CA, n_res)
    return np.stack([phi, psi, omega, tau, ca_c_n, c_n_ca], axis=1)


def cath_like_lengths(rng: np.random.Generator, n: int, min_len: int = 40, max_len: int = 512) -> np.ndarray:
    """CATH-S40-like domain lengths: lognormal with median ~140 residues,
    clipped to [min_len, max_len]; ~58% of draws exceed the pad of 128, as
    most CATH domains do (reference config_jsons/cath_full_angles_cosine.json)."""
    lens = rng.lognormal(mean=np.log(140.0), sigma=0.45, size=n)
    return np.clip(np.round(lens), min_len, max_len).astype(int)


def make_synthetic_protein_dir(out_dir: str, n: int = 200, min_len: int = 48, max_len: int = 96,
                               seed: int = 0) -> List[str]:
    """Write n synthetic multi-segment protein backbones as PDBs."""
    from foldingdiff_tpu_torch.geometry.featurize import EXHAUSTIVE_ANGLES, create_new_chain_nerf

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        n_res = int(rng.integers(min_len, max_len + 1))
        fname = os.path.join(out_dir, f"synthprot_{i:04d}.pdb")
        if create_new_chain_nerf(fname, synth_angles(rng, n_res), EXHAUSTIVE_ANGLES):
            out.append(fname)
    return out


def _pdb_is_complete(fname: str) -> bool:
    """A PDB written by geometry.pdb is complete iff it ends with 'END\\n'
    (its writes are atomic; this also guards files copied in partially)."""
    try:
        with open(fname, "rb") as fh:
            fh.seek(-4, os.SEEK_END)
            return fh.read() == b"END\n"
    except OSError:
        return False


def make_cath_scale_corpus(out_dir: str, n: int = 24000, seed: int = 0, resume: bool = True) -> List[str]:
    """Write a CATH-S40-sized synthetic corpus: n multi-segment backbones
    with CATH-like lengths (cath_like_lengths). resume=True skips files that
    exist and are complete; a truncated file is rewritten. The angles of a
    skipped file are drawn all the same, so a resumed run writes the same
    remaining files."""
    from foldingdiff_tpu_torch.geometry.featurize import EXHAUSTIVE_ANGLES, create_new_chain_nerf

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    lengths = cath_like_lengths(rng, n)
    out = []
    for i, n_res in enumerate(lengths):
        fname = os.path.join(out_dir, f"synthprot_{i:05d}.pdb")
        angles = synth_angles(rng, int(n_res))
        if resume and _pdb_is_complete(fname):
            out.append(fname)
            continue
        if create_new_chain_nerf(fname, angles, EXHAUSTIVE_ANGLES):
            out.append(fname)
    return out
