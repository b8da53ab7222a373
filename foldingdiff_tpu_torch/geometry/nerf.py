"""
NeRF (Natural Extension Reference Frame): internal coordinates -> Cartesian
(counterpart of foldingdiff_tpu/geometry/nerf.py, host path only).

The float64 numpy chain build that PDB writing uses, as in the JAX package.
Angle storage convention: row i of the bond-angle features holds the value
consumed when placing residue i+1; the build consumes psi[:-1], omega[:-1],
phi[1:].
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

# Idealized backbone bond lengths (angstroms), reference nerf.py:17-19
N_CA_LENGTH = 1.46
CA_C_LENGTH = 1.54
C_N_LENGTH = 1.34

# Idealized bond angles (radians), reference nerf.py:40-42
BOND_ANGLE_N_CA = 121.0 / 180.0 * np.pi  # C:1N:1CA
BOND_ANGLE_CA_C = 109.0 / 180.0 * np.pi  # tau = N:CA:C
BOND_ANGLE_C_N = 115.0 / 180.0 * np.pi  # CA:C:1N

# Initial seed coordinates: N/CA/C of 1CRN's first residue (reference nerf.py:22-24)
N_INIT = np.array([17.047, 14.099, 3.625])
CA_INIT = np.array([16.967, 12.784, 4.338])
C_INIT = np.array([15.685, 12.755, 5.133])
INIT_COORDS = np.stack([N_INIT, CA_INIT, C_INIT])  # (3, 3)


def place_dihedral_np(a, b, c, bond_angle, bond_length, torsion_angle) -> np.ndarray:
    """
    Place atom d so that (a, b, c, d) has the given c-d bond length, b-c-d
    bond angle and a-b-c-d torsion, in float64. Points (..., 3), scalars (...,).
    """
    a, b, c = (np.asarray(x, dtype=np.float64) for x in (a, b, c))
    bond_angle = np.asarray(bond_angle, dtype=np.float64)[..., None]
    bond_length = np.asarray(bond_length, dtype=np.float64)[..., None]
    torsion_angle = np.asarray(torsion_angle, dtype=np.float64)[..., None]

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    ab = b - a
    bc = unit(c - b)
    n = unit(np.cross(ab, bc))
    nbc = np.cross(n, bc)
    d_local = (
        -bond_length * np.cos(bond_angle) * bc
        + bond_length * np.cos(torsion_angle) * np.sin(bond_angle) * nbc
        + bond_length * np.sin(torsion_angle) * np.sin(bond_angle) * n
    )
    return d_local + c


def nerf_build_np(
    phi: np.ndarray,
    psi: np.ndarray,
    omega: np.ndarray,
    bond_angle_n_ca_c: Optional[np.ndarray] = None,  # tau
    bond_angle_ca_c_n: Optional[np.ndarray] = None,
    bond_angle_c_n_ca: Optional[np.ndarray] = None,
    bond_len_n_ca: Union[float, np.ndarray, None] = None,
    bond_len_ca_c: Union[float, np.ndarray, None] = None,
    bond_len_c_n: Union[float, np.ndarray, None] = None,
    init_coords: np.ndarray = INIT_COORDS,
) -> np.ndarray:
    """
    Float64 single-chain build (reference NERFBuilder, nerf.py:27-142).
    Inputs are (L,) arrays; missing bond angles/lengths fall back to the
    idealized constants. Returns (3L, 3) coords ordered N, CA, C per residue.
    """
    phi = np.asarray(phi, dtype=np.float64).reshape(-1)
    psi = np.asarray(psi, dtype=np.float64).reshape(-1)
    omega = np.asarray(omega, dtype=np.float64).reshape(-1)
    length = phi.shape[0]

    def param(v, default):
        if v is None:
            return np.full(length, default, dtype=np.float64)
        v = np.asarray(v, dtype=np.float64)
        return np.broadcast_to(v, (length,)).astype(np.float64)

    ang_n_ca_c = param(bond_angle_n_ca_c, BOND_ANGLE_CA_C)
    ang_ca_c_n = param(bond_angle_ca_c_n, BOND_ANGLE_C_N)
    ang_c_n_ca = param(bond_angle_c_n_ca, BOND_ANGLE_N_CA)
    len_n_ca = param(bond_len_n_ca, N_CA_LENGTH)
    len_ca_c = param(bond_len_ca_c, CA_C_LENGTH)
    len_c_n = param(bond_len_c_n, C_N_LENGTH)

    coords = [np.asarray(c, dtype=np.float64) for c in init_coords]
    for i in range(length - 1):
        n_at = place_dihedral_np(
            coords[-3], coords[-2], coords[-1], ang_ca_c_n[i], len_c_n[i], psi[i]
        )
        ca_at = place_dihedral_np(
            coords[-2], coords[-1], n_at, ang_c_n_ca[i], len_n_ca[i], omega[i]
        )
        c_at = place_dihedral_np(
            coords[-1], n_at, ca_at, ang_n_ca_c[i], len_ca_c[i], phi[i + 1]
        )
        coords.extend([n_at, ca_at, c_at])
    return np.array(coords)
