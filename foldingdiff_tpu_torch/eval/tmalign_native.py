"""
ctypes binding of the repository's C++ TM-align (csrc/tmalign.cpp), the
port's own copy of foldingdiff_tpu/eval/tmalign_native.py.

The library is built with g++ on first use, with the JAX package's flags,
into foldingdiff_tpu_torch/_build/. Its name carries a hash of the source,
the flags and this host's CPU model and flag list (-march=native code may
not run on another CPU), so an edited source or another host builds anew.
The build writes a temporary file and renames it into place, so processes
that build at once never load a half-written library. When g++ or the
source is missing, available() is false and eval/tmscore.py takes its numpy
path. Which of the two a process uses is logged once, when it first loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR.parent / "csrc" / "tmalign.cpp"
BUILD_DIR = _PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_cpu() -> bytes:
    """The CPU model and flag lines of /proc/cpuinfo (empty where there is none)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [line for line in lines if line.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def library_path() -> Path:
    blob = SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode() + _host_cpu()
    return BUILD_DIR / f"libtmalign_{hashlib.sha256(blob).hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logging.warning(f"Could not build native TM-align: {e}")
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if SOURCE.is_file():
        path = library_path()
        if path.is_file() or _build(path):
            try:
                lib = ctypes.CDLL(str(path))
                lib.tm_align_ex.restype = ctypes.c_double
                lib.tm_align_ex.argtypes = [
                    ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                ]
                _lib = lib
            except OSError as e:
                logging.warning(f"Could not load native TM-align: {e}")
    else:
        logging.warning(f"Could not build native TM-align: no source at {SOURCE}")
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
