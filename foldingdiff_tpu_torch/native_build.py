"""
The host C++ sources of the repository (csrc/tmalign.cpp,
csrc/featurize.cpp), built with g++ on first use, with the JAX package's
flags, into foldingdiff_tpu_torch/_build/ and loaded with ctypes
(eval/tmalign_native.py, data/featurize_native.py).

A library's name carries a hash of its source, the flags and this host's CPU
model and flag list (-march=native code may not run on another CPU), so an
edited source or another host builds anew. The build writes a temporary
file and renames it into place, so processes that build at once never load
a half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def _host_cpu() -> bytes:
    """The CPU model and flag lines of /proc/cpuinfo (empty where there is none)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [line for line in lines if line.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def library_path(source: Path, stem: str) -> Path:
    blob = source.read_bytes() + " ".join(GXX_FLAGS).encode() + _host_cpu()
    return BUILD_DIR / f"{stem}_{hashlib.sha256(blob).hexdigest()[:16]}.so"


def _build(source: Path, out: Path, what: str) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(source)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logging.warning(f"Could not build {what}: {e}")
        tmp.unlink(missing_ok=True)
        return False


def load(source: Path, stem: str, what: str) -> Optional[ctypes.CDLL]:
    """The library built from `source` (built first if it is not there), or
    None, with a warning naming `what`, where the source or g++ is missing
    or the build or the load fails."""
    if not source.is_file():
        logging.warning(f"Could not build {what}: no source at {source}")
        return None
    path = library_path(source, stem)
    if not (path.is_file() or _build(source, path, what)):
        return None
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        logging.warning(f"Could not load {what}: {e}")
        return None
