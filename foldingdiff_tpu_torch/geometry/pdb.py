"""
PDB backbone writing (counterpart of foldingdiff_tpu/geometry/pdb.py,
writer only): GLY-only N/CA/C backbones in the style of the reference
write_coords_to_pdb (chain A, occupancy 1.0, b-factor 5.0).
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import numpy as np


def _format_atom_line(
    serial: int,
    name: str,
    res_name: str,
    chain_id: str,
    res_id: int,
    coord,
    occupancy: float,
    b_factor: float,
    element: str,
) -> str:
    # PDB atom-name convention: names of <4 chars start in column 14
    name_field = f" {name:<3s}" if len(name) < 4 else f"{name:<4s}"
    return (
        f"ATOM  {serial:>5d} {name_field}{'':1s}{res_name:>3s} {chain_id}"
        f"{res_id:>4d}{'':1s}   "
        f"{coord[0]:>8.3f}{coord[1]:>8.3f}{coord[2]:>8.3f}"
        f"{occupancy:>6.2f}{b_factor:>6.2f}          {element:>2s}\n"
    )


@contextmanager
def _atomic_write(out_fname: str):
    """Write to a temporary file and os.replace it into place, so a PDB
    either exists complete or not at all."""
    tmp = f"{out_fname}.tmp.{os.getpid()}"
    fh = open(tmp, "w")
    try:
        yield fh
        fh.close()
        os.replace(tmp, out_fname)
    except BaseException:
        fh.close()
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def write_coords_to_pdb(coords: np.ndarray, out_fname: str) -> str:
    """
    Write an (3N, 3) N/CA/C coordinate array as a GLY-only backbone PDB,
    matching reference angles_and_coords.write_coords_to_pdb (187-253).
    """
    coords = np.asarray(coords)
    if len(coords) % 3:
        raise ValueError(f"Expected 3N coords, got {len(coords)}")
    elements = ["N", "C", "C"]
    names = ["N", "CA", "C"]
    with _atomic_write(out_fname) as fh:
        serial = 1
        for i in range(0, len(coords), 3):
            res_id = i // 3 + 1
            for j in range(3):
                fh.write(
                    _format_atom_line(
                        serial, names[j], "GLY", "A", res_id, coords[i + j],
                        1.0, 5.0, elements[j],
                    )
                )
                serial += 1
        fh.write("END\n")
    return out_fname
