"""
ctypes binding of the repository's C++ TM-align (csrc/tmalign.cpp), the
port's own copy of foldingdiff_tpu/eval/tmalign_native.py.

The library is built with g++ on first use into foldingdiff_tpu_torch/_build/
(native_build.py). When g++ or the source is missing, available() is false
and eval/tmscore.py takes its numpy path. Which of the two a process uses is
logged once, when it first loads.
"""
from __future__ import annotations

import ctypes
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from foldingdiff_tpu_torch import native_build

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "tmalign.cpp"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    return native_build.library_path(SOURCE, "libtmalign")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = native_build.load(SOURCE, "libtmalign", "native TM-align")
    if lib is not None:
        lib.tm_align_ex.restype = ctypes.c_double
        lib.tm_align_ex.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
    logging.info(f"TM-score path: native TM-align ({library_path().name})" if _lib is not None
                 else "TM-score path: the numpy fallback (eval/tmscore.tm_score)")
    return _lib


def available() -> bool:
    return _load() is not None


def _as_ptr(arr: np.ndarray):
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def tm_align_coords(query: np.ndarray, reference: np.ndarray, fast: bool = False) -> float:
    """TM-score of the query CA trace aligned onto the reference, normalized
    by the reference length: the full DP alignment, or with fast=True the
    screening-grade truncated search (TM-align's -fast). Negative when a
    trace has fewer than 5 residues."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native TM-align is not available")
    q, qp = _as_ptr(query)
    r, rp = _as_ptr(reference)
    return float(lib.tm_align_ex(qp, len(q), rp, len(r), 1 if fast else 0))


def run_tmalign(query_pdb: str, reference_pdb: str, fast: bool = False) -> float:
    """File-level TM-score of two PDBs' CA traces; NaN on failure
    (reference tmalign.py:22-54)."""
    from foldingdiff_tpu_torch.eval.tmscore import _load_ca

    q = _load_ca(query_pdb)
    r = _load_ca(reference_pdb)
    if q is None or r is None:
        return float("nan")
    score = tm_align_coords(q, r, fast=fast)
    return score if score >= 0 else float("nan")
