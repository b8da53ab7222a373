"""
Secondary-structure annotation on the host (counterpart of
foldingdiff_tpu/metrics/ss.py): the P-SEA algorithm (Labesse et al., CABIOS
1997) from CA geometry only, the algorithm behind biotite's annotate_sse that
the reference uses (bin/annot_secondary_structures.py:80-88). Generated
backbones are sequence-less N/CA/C chains, which rules out DSSP-style H-bond
analysis by default; an external DSSP binary is an option, behind
shutil.which.

Per-residue labels 'a' (alpha helix), 'b' (beta strand), 'c' (coil), and
the element counts (contiguous alpha and beta segments) that the baselines
are compared by. numpy only.
"""
from __future__ import annotations

import os
from itertools import groupby
from typing import Collection, List, Tuple

import numpy as np

from foldingdiff_tpu_torch.geometry.featurize import bond_angle_np, dihedral_np
from foldingdiff_tpu_torch.geometry.pdb import extract_backbone_coords

_D = np.pi / 180.0
# P-SEA parameter ranges: (helix, strand)
R_HELIX = ((89.9 - 12.0) * _D, (89.9 + 12.0) * _D)
A_HELIX = ((50.0 - 20.0) * _D, (50.0 + 20.0) * _D)
D2_HELIX = (5.5 - 0.5, 5.5 + 0.5)
D3_HELIX = (5.3 - 0.5, 5.3 + 0.5)
D4_HELIX = (6.4 - 0.6, 6.4 + 0.6)

R_STRAND = ((124.0 - 14.0) * _D, (124.0 + 14.0) * _D)
A_STRAND = ((-180.0) * _D, (-125.0) * _D, (145.0) * _D, (180.0) * _D)
D2_STRAND = (6.7 - 0.6, 6.7 + 0.6)
D3_STRAND = (9.9 - 0.9, 9.9 + 0.9)
D4_STRAND = (12.4 - 1.1, 12.4 + 1.1)


def _in(x, lo, hi):
    return (x >= lo) & (x <= hi)


def annotate_sse_ca(ca: np.ndarray) -> np.ndarray:
    """P-SEA labels ('a'/'b'/'c') for an (N, 3) CA trace."""
    n = len(ca)
    labels = np.full(n, "c", dtype="<U1")
    if n < 5:
        return labels

    nan = np.full(n, np.nan)
    d2, d3, d4, r, a = (nan.copy() for _ in range(5))
    d2[: n - 2] = np.linalg.norm(ca[2:] - ca[:-2], axis=-1)
    d3[: n - 3] = np.linalg.norm(ca[3:] - ca[:-3], axis=-1)
    d4[: n - 4] = np.linalg.norm(ca[4:] - ca[:-4], axis=-1)
    r[1 : n - 1] = bond_angle_np(ca[:-2], ca[1:-1], ca[2:])
    a[1 : n - 2] = dihedral_np(ca[:-3], ca[1:-2], ca[2:-1], ca[3:])

    with np.errstate(invalid="ignore"):
        helix_cand = (_in(d3, *D3_HELIX) & _in(d4, *D4_HELIX)) | (
            _in(r, *R_HELIX) & _in(a, *A_HELIX)
        )
        strand_cand = (
            _in(d2, *D2_STRAND) & _in(d3, *D3_STRAND) & _in(d4, *D4_STRAND)
        ) | (
            _in(r, *R_STRAND)
            & (_in(a, A_STRAND[0], A_STRAND[1]) | _in(a, A_STRAND[2], A_STRAND[3]))
        )
    helix_cand = np.nan_to_num(helix_cand).astype(bool)
    strand_cand = np.nan_to_num(strand_cand).astype(bool)

    # Helix: runs of >= 5 consecutive candidate residues; the satisfied
    # criteria at index i cover residues i..i+3/4, so mark forward
    labels = _mark_runs(labels, helix_cand, min_run=5, label="a", span=4)
    labels = _mark_runs(labels, strand_cand, min_run=3, label="b", span=4)
    return labels


def _mark_runs(labels: np.ndarray, cand: np.ndarray, min_run: int, label: str, span: int):
    n = len(labels)
    i = 0
    while i < n:
        if not cand[i]:
            i += 1
            continue
        j = i
        while j < n and cand[j]:
            j += 1
        if j - i >= min_run:
            end = min(n, j - 1 + span)
            for k in range(i, end):
                if labels[k] == "c":  # helix assignment wins over strand
                    labels[k] = label
        i = j
    return labels


def annotate_pdb_sse(fname: str) -> np.ndarray:
    ca = extract_backbone_coords(fname, atoms=("CA",))
    if ca is None:
        return np.array([], dtype="<U1")
    return annotate_sse_ca(np.asarray(ca))


def dssp_available() -> bool:
    import shutil

    return any(shutil.which(b) for b in ("mkdssp", "dssp"))


def _parse_dssp_text(stdout: str) -> np.ndarray:
    labels = []
    in_table = False
    for line in stdout.splitlines():
        if line.startswith("  #  RESIDUE"):
            in_table = True
            continue
        if not in_table or len(line) < 17:
            continue
        if line[13] == "!":  # chain break record
            continue
        code = line[16]
        labels.append("a" if code in "HGI" else ("b" if code in "EB" else "c"))
    return np.asarray(labels, dtype="<U1")


def annotate_pdb_sse_dssp(fname: str) -> np.ndarray:
    """
    SS annotation via the external DSSP binary (the reference's optional
    backend, bin/annot_secondary_structures.py:89-99): H/G/I -> 'a',
    E/B -> 'b', else 'c'. Raises RuntimeError when no DSSP is installed --
    P-SEA is the always-available default. Per-file failures (malformed PDB,
    non-zero exit) return an empty array so callers get the (-1, -1) sentinel
    instead of aborting a whole parallel sweep.
    """
    import shutil
    import subprocess

    binary = next((b for b in ("mkdssp", "dssp") if shutil.which(b)), None)
    if binary is None:
        raise RuntimeError(
            "DSSP backend requested but no mkdssp/dssp binary on PATH; "
            "use the native P-SEA backend instead"
        )
    # DSSP 4.x (the modern mkdssp) defaults to mmCIF output; request the
    # classic text format explicitly, falling back for 2.x/3.x binaries that
    # predate the flag.
    for args in (
        [binary, "--output-format", "dssp", str(fname)],
        [binary, str(fname)],
    ):
        proc = subprocess.run(args, capture_output=True, text=True, check=False)
        if proc.returncode == 0:
            parsed = _parse_dssp_text(proc.stdout)
            if parsed.size > 0:
                return parsed
            # A legacy binary may exit 0 while printing usage for the unknown
            # flag (or write the error to stdout): an empty table from the
            # flagged invocation means "flag not understood", not "no SS" --
            # fall through to the plain invocation before giving up.
            continue
        if "output-format" not in (proc.stderr or ""):
            break  # real failure on this file, not an unknown-flag error
    return np.asarray([], dtype="<U1")


def count_structures_in_pdb(fname: str, backend: str = "psea") -> Tuple[int, int]:
    """(# alpha elements, # beta elements) -- reference
    bin/annot_secondary_structures.py:64-105. (-1, -1) on failure.
    backend: "psea" (native, default) or "dssp" (external binary)."""
    assert backend in ("psea", "dssp"), f"Unknown SS backend {backend}"
    if not os.path.exists(fname):
        return (-1, -1)
    ss = annotate_pdb_sse(fname) if backend == "psea" else annotate_pdb_sse_dssp(fname)
    if ss.size == 0:
        return (-1, -1)
    grouped = [k for k, _ in groupby(ss)]
    return int(sum(1 for k in grouped if k == "a")), int(sum(1 for k in grouped if k == "b"))


def count_structures_parallel(
    fnames: Collection[str], threads: int = os.cpu_count() or 1, backend: str = "psea"
) -> List[Tuple[int, int]]:
    import functools
    import multiprocessing as mp

    fn = functools.partial(count_structures_in_pdb, backend=backend)
    if threads > 1 and len(fnames) > 8:
        with mp.get_context("spawn").Pool(threads) as pool:
            return list(pool.map(fn, fnames, chunksize=10))
    return [fn(f) for f in fnames]
