"""
PDB <-> internal angles (counterpart of foldingdiff_tpu/geometry/featurize.py),
numpy only. A feature table is an (L, F) float64 array with its column names
instead of a DataFrame, so the path needs no pandas.

Feature layout (row i of an L-residue chain; reference
angles_and_coords.py:30-109):

  phi[i]      : dihedral C_{i-1}-N_i-CA_i-C_i      (NaN at i=0)
  psi[i]      : dihedral N_i-CA_i-C_i-N_{i+1}      (NaN at i=L-1)
  omega[i]    : dihedral CA_i-C_i-N_{i+1}-CA_{i+1} (NaN at i=L-1)
  tau[i]      : bond angle N-CA-C of residue i+1   (NaN at i=L-1)  [shifted]
  CA:C:1N[i]  : angle CA_i-C_i-N_{i+1}             (NaN at i=L-1)
  C:1N:1CA[i] : angle C_i-N_{i+1}-CA_{i+1}         (NaN at i=L-1)
  0C:1N[i]    : dist C_i to N_{i+1}                (0.0 at i=L-1)
  N:CA[i]     : dist N-CA of residue i+1           (0.0 at i=L-1)  [shifted]
  CA:C[i]     : dist CA-C of residue i+1           (0.0 at i=L-1)  [shifted]

Row i of a shifted column holds the value NeRF consumes when it places
residue i+1. The last row's padding is NaN for angles and 0 for distances,
as biotite's index_angle and index_distance give.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from foldingdiff_tpu_torch.geometry import nerf
from foldingdiff_tpu_torch.geometry.pdb import read_pdb, write_coords_to_pdb

EXHAUSTIVE_ANGLES = ["phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA"]
EXHAUSTIVE_DISTS = ["0C:1N", "N:CA", "CA:C"]
MINIMAL_ANGLES = ["phi", "psi", "omega"]
MINIMAL_DISTS: List[str] = []


def dihedral_np(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray, p3: np.ndarray) -> np.ndarray:
    """
    Signed dihedral of point quadruples, IUPAC convention (biotite's
    struc.dihedral, the inverse of nerf.place_dihedral_np). Broadcasts over
    leading dims; points are (..., 3).
    """
    b1, b2, b3 = p1 - p0, p2 - p1, p3 - p2
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    m1 = np.cross(b2 / np.linalg.norm(b2, axis=-1, keepdims=True), n1)
    return np.arctan2(np.sum(m1 * n2, axis=-1), np.sum(n1 * n2, axis=-1))


def bond_angle_np(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Interior angle at p1 of the p0-p1-p2 triple, in [0, pi]."""
    v1 = p0 - p1
    v2 = p2 - p1
    v1 = v1 / np.linalg.norm(v1, axis=-1, keepdims=True)
    v2 = v2 / np.linalg.norm(v2, axis=-1, keepdims=True)
    return np.arccos(np.clip(np.sum(v1 * v2, axis=-1), -1.0, 1.0))


def backbone_dihedrals(bb: np.ndarray):
    """
    phi, psi and omega of an (3L, 3) N/CA/C backbone array, with biotite
    dihedral_backbone's NaN placement (phi[0], psi[-1], omega[-1] NaN).
    """
    n_res = len(bb) // 3
    n_at, ca_at, c_at = bb[0::3], bb[1::3], bb[2::3]
    phi, psi, omega = (np.full(n_res, np.nan) for _ in range(3))
    if n_res >= 2:
        phi[1:] = dihedral_np(c_at[:-1], n_at[1:], ca_at[1:], c_at[1:])
        psi[:-1] = dihedral_np(n_at[:-1], ca_at[:-1], c_at[:-1], n_at[1:])
        omega[:-1] = dihedral_np(ca_at[:-1], c_at[:-1], n_at[1:], ca_at[1:])
    return phi, psi, omega


def featurize_backbone(
    bb: np.ndarray,
    distances: Sequence[str] = MINIMAL_DISTS,
    angles: Sequence[str] = MINIMAL_ANGLES,
) -> Tuple[np.ndarray, List[str]]:
    """An (3L, 3) backbone coordinate array as the (L, F) float64 feature
    table, distances then angles, and its column names."""
    if len(bb) % 3 or len(bb) < 6:
        raise ValueError(f"Bad backbone shape {bb.shape}")
    n_at, ca_at, c_at = bb[0::3], bb[1::3], bb[2::3]
    phi, psi, omega = backbone_dihedrals(bb)
    calc = {"phi": phi, "psi": psi, "omega": omega}

    def pad_nan(vals):
        return np.concatenate([vals, [np.nan]])

    def pad_zero(vals):
        return np.concatenate([vals, [0.0]])

    for a in angles:
        if a in calc:
            continue
        if a in ("tau", "N:CA:C"):  # residues 1..L-1, stored at rows 0..L-2
            calc[a] = pad_nan(bond_angle_np(n_at[1:], ca_at[1:], c_at[1:]))
        elif a == "CA:C:1N":
            calc[a] = pad_nan(bond_angle_np(ca_at[:-1], c_at[:-1], n_at[1:]))
        elif a == "C:1N:1CA":
            calc[a] = pad_nan(bond_angle_np(c_at[:-1], n_at[1:], ca_at[1:]))
        else:
            raise ValueError(f"Unrecognized angle: {a}")
    for d in distances:
        if d in ("0C:1N", "C:1N"):
            calc[d] = pad_zero(np.linalg.norm(n_at[1:] - c_at[:-1], axis=-1))
        elif d == "N:CA":
            calc[d] = pad_zero(np.linalg.norm(ca_at[1:] - n_at[1:], axis=-1))
        elif d == "CA:C":
            calc[d] = pad_zero(np.linalg.norm(c_at[1:] - ca_at[1:], axis=-1))
        else:
            raise ValueError(f"Unrecognized distance: {d}")
    names = [*distances, *angles]
    return np.column_stack([calc[k] for k in names]).astype(np.float64), names


def canonical_distances_and_dihedrals(
    fname: str,
    distances: Sequence[str] = MINIMAL_DISTS,
    angles: Sequence[str] = MINIMAL_ANGLES,
) -> Optional[Tuple[np.ndarray, List[str]]]:
    """
    A PDB file as the (L, F) feature table and its column names; None on
    malformed input (multi-model, missing backbone atoms, angles out of
    range), as the reference skips them (angles_and_coords.py:42-43, 51-53,
    77-81).
    """
    if not os.path.isfile(fname):
        raise FileNotFoundError(f"Missing file: {fname}")
    struct = read_pdb(fname)
    if struct.model_count > 1:
        return None
    bb = struct.backbone_coords()
    if len(bb) < 6 or len(bb) % 3 != 0:
        logging.debug(f"{fname}: malformed backbone ({len(bb)} atoms) - skipping")
        return None
    try:
        values, names = featurize_backbone(bb, distances=distances, angles=angles)
    except (ValueError, FloatingPointError):
        return None
    for col in angles:
        v = values[:, names.index(col)]
        finite = v[np.isfinite(v)]
        if finite.size and not (finite.min() >= -np.pi - 1e-9 and finite.max() <= np.pi + 1e-9):
            logging.warning(f"Illegal values for {col} in {fname} -- skipping")
            return None
    return values, names


_ANGLE_KWARGS = {
    "tau": "bond_angle_n_ca_c",
    "N:CA:C": "bond_angle_n_ca_c",
    "CA:C:1N": "bond_angle_ca_c_n",
    "C:1N:1CA": "bond_angle_c_n_ca",
}
_DIST_KWARGS = {"0C:1N": "bond_len_c_n", "N:CA": "bond_len_n_ca", "CA:C": "bond_len_ca_c"}


def create_new_chain_nerf(
    out_fname: str,
    dists_and_angles: np.ndarray,
    feature_names: Sequence[str],
) -> str:
    """
    Angles -> PDB via NeRF (reference angles_and_coords.py:112-184), with the
    coordinates centred. dists_and_angles is (L, F) with columns named by
    feature_names; names with exactly one ':' are distances, all others
    angles. Returns the written path, or "" if the build produced NaNs.
    """
    values = np.asarray(dists_and_angles)
    columns = {name: values[:, i] for i, name in enumerate(feature_names)}
    angles_to_set, dists_to_set = [], []
    for c in feature_names:
        (dists_to_set if str(c).count(":") == 1 else angles_to_set).append(c)
    if not all(a in angles_to_set for a in ("phi", "psi", "omega")):
        raise ValueError(f"phi, psi and omega are required, got {angles_to_set}")

    kwargs = {a: columns[a] for a in ("phi", "psi", "omega")}
    for a in angles_to_set:
        if a in ("phi", "psi", "omega"):
            continue
        if a not in _ANGLE_KWARGS:
            raise ValueError(f"Unrecognized angle: {a}")
        kwargs[_ANGLE_KWARGS[a]] = columns[a]
    for d in dists_to_set:
        if d not in _DIST_KWARGS:
            raise ValueError(f"Unrecognized distance: {d}")
        kwargs[_DIST_KWARGS[d]] = columns[d]

    coords = nerf.nerf_build_np(**kwargs)
    coords = coords - coords.mean(axis=0)
    if np.any(np.isnan(coords)):
        logging.warning(f"Found NaN values, not writing pdb file {out_fname}")
        return ""
    return write_coords_to_pdb(coords, out_fname)
