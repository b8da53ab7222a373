"""
ctypes binding of the repository's C++ PDB featurizer (csrc/featurize.cpp),
the port's own copy of foldingdiff_tpu/data/featurize_native.py.

The library is built with g++ on first use into foldingdiff_tpu_torch/_build/
(native_build.py). data/datasets.py prefers it to the numpy path of
geometry/featurize.canonical_distances_and_dihedrals, which it matches
within 1e-9 (tests/test_torch_eval.py); where g++ or the source is missing,
available() is false and the dataset layer takes the numpy path.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from foldingdiff_tpu_torch import native_build

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "featurize.cpp"
COLUMNS = ["0C:1N", "N:CA", "CA:C", "phi", "psi", "omega", "tau", "CA:C:1N", "C:1N:1CA"]
MAX_RES = 4096

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    return native_build.library_path(SOURCE, "libfeaturize")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = native_build.load(SOURCE, "libfeaturize", "the native featurizer")
    if lib is not None:
        lib.featurize_pdb.restype = ctypes.c_int
        lib.featurize_pdb.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def featurize_pdb_native(fname: str) -> Optional[np.ndarray]:
    """(n_res, 9) float64 features in COLUMNS order, or None where the file
    fails (missing, multi-model, malformed, gzipped: gzip takes the numpy
    path) or the library is not available."""
    if str(fname).endswith(".gz"):
        return None
    lib = _load()
    if lib is None:
        return None
    out = np.empty((MAX_RES, 9), dtype=np.float64)
    n = lib.featurize_pdb(str(fname).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), MAX_RES)
    if n < 2:
        return None
    return out[:n].copy()
