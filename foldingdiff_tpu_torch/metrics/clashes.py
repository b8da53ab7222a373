"""
Van der Waals clashes of backbones, on the host (counterpart of
foldingdiff_tpu/metrics/clashes.py; reference foldingdiff/vdw_clashes.py):
backbone atoms only, a clash where two non-adjacent atoms lie within
alpha * (r_i + r_j), counted as the atoms with any clash. numpy only.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from typing import Collection, Dict

import numpy as np

from foldingdiff_tpu_torch.geometry.pdb import read_pdb

VDW_RADII = {"C": 1.7, "N": 1.55}


def count_clashes(fname: str, alpha: float = 0.63) -> int:
    """Number of backbone atoms involved in at least one clash."""
    struct = read_pdb(fname)
    atoms = [a for a in struct.atoms if (not a.hetero) and a.name in ("N", "CA", "C")]
    coords = np.stack([a.coord for a in atoms])
    elements = np.array([VDW_RADII[a.element if a.element in VDW_RADII else "C"] for a in atoms])

    diff = coords[:, None, :] - coords[None, :, :]
    dists = np.sqrt((diff**2).sum(-1))
    thresh = alpha * (elements[:, None] + elements[None, :])
    idx = np.arange(len(atoms))
    adjacent = np.abs(idx[:, None] - idx[None, :]) <= 1  # self and direct neighbours
    is_clash = (dists <= thresh) & ~adjacent
    return int(np.sum(np.any(is_clash, axis=1)))


def count_clashes_parallel(filenames: Collection[str], nthreads: int = os.cpu_count() or 1) -> Dict[str, int]:
    """{file: count_clashes(file)}, in a process pool above 8 files."""
    if nthreads > 1 and len(filenames) > 8:
        with mp.get_context("spawn").Pool(nthreads) as pool:
            counts = pool.map(count_clashes, filenames, chunksize=10)
    else:
        counts = [count_clashes(f) for f in filenames]
    return dict(zip(filenames, counts))
