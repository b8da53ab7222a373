"""
Angles -> PDB (counterpart of foldingdiff_tpu/geometry/featurize.py:
create_new_chain_nerf). The features come as an (L, F) numpy array with
their names instead of a DataFrame, so the path needs no pandas.
"""
from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

from foldingdiff_tpu_torch.geometry import nerf
from foldingdiff_tpu_torch.geometry.pdb import write_coords_to_pdb

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
