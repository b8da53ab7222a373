"""
TM-score and structural similarity (the port's own copy of
foldingdiff_tpu/eval/tmscore.py), numpy only:

- `tm_score(q, r)`: the TM-score (Zhang & Skolnick 2004) of two CA traces.
  Equal lengths take the identity correspondence; unequal lengths thread the
  shorter chain gaplessly along the longer. Both use the TM-score program's
  iterative superposition search (seed fragments of decreasing size, then
  d0-cutoff refinement).
- `run_tmalign(query, reference)`: the reference wrapper's file-level API
  (tmalign.py:22-54): the TM-score normalized by the REFERENCE length, NaN
  on failure. It takes the C++ TM-align of eval/tmalign_native.py when that
  builds, else `tm_score`.
- `max_tm_across_refs` and `match_files` (reference tmalign.py:57-112).
- `score_reconstruction`: the TM-scores of one partial-noise
  reconstruction (reference sampling._score_angles), the unit of work of
  bin/partial_noise_reconstruct_torch.py's process pool.
"""
from __future__ import annotations

import logging
import multiprocessing as mp
import os
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from foldingdiff_tpu_torch.eval import tmalign_native


def kabsch(P: np.ndarray, Q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """
    Optimal rotation R and translation t minimizing ||P @ R.T + t - Q||.
    P, Q: (N, 3). Returns (R, t) mapping P into Q's frame.
    """
    pc = P.mean(axis=0)
    qc = Q.mean(axis=0)
    H = (P - pc).T @ (Q - qc)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = qc - R @ pc
    return R, t


def tm_d0(length: int) -> float:
    """TM-score normalization distance d0(L)."""
    if length > 15:
        return 1.24 * (length - 15) ** (1.0 / 3.0) - 1.8
    return 0.5


def _tm_from_superposition(
    moving: np.ndarray, fixed: np.ndarray, sub_idx: np.ndarray, d0: float, norm_len: int
) -> Tuple[float, np.ndarray]:
    """Superimpose on sub_idx, score ALL aligned pairs. Returns (tm, dists)."""
    if len(sub_idx) < 3:
        return -1.0, np.full(len(moving), np.inf)
    R, t = kabsch(moving[sub_idx], fixed[sub_idx])
    moved = moving @ R.T + t
    dists = np.linalg.norm(moved - fixed, axis=1)
    tm = float(np.sum(1.0 / (1.0 + (dists / d0) ** 2)) / norm_len)
    return tm, dists


def _tm_score_aligned(moving: np.ndarray, fixed: np.ndarray, norm_len: int) -> float:
    """
    TM-score for a fixed 1:1 correspondence, with the iterative search from the
    TM-score program: seed fragments L, L/2, L/4 ... 4; refine each seed by
    re-superimposing on residues within a distance cutoff until convergence.
    """
    n = len(moving)
    if moving.shape != fixed.shape or n < 3:
        raise ValueError(f"need two equal (N >= 3, 3) traces, got {moving.shape} and {fixed.shape}")
    d0 = max(tm_d0(norm_len), 0.5)
    best = -1.0

    frag = n
    frags = []
    while frag >= 4:
        frags.append(frag)
        frag //= 2
    if not frags:
        frags = [n]

    for fl in frags:
        starts = range(0, n - fl + 1, max(1, fl // 2))
        for s in starts:
            idx = np.arange(s, s + fl)
            tm, dists = _tm_from_superposition(moving, fixed, idx, d0, norm_len)
            best = max(best, tm)
            # Iterative refinement with a growing cutoff if too few pairs
            for _ in range(20):
                d_cut = d0
                sel = np.where(dists < d_cut)[0]
                while len(sel) < 3 and d_cut < 8.0 * d0:
                    d_cut += 0.5
                    sel = np.where(dists < d_cut)[0]
                if len(sel) < 3:
                    break
                tm_new, dists_new = _tm_from_superposition(moving, fixed, sel, d0, norm_len)
                best = max(best, tm_new)
                if np.array_equal(np.where(dists_new < d_cut)[0], sel):
                    break
                dists = dists_new
    return best


def tm_score(query: np.ndarray, reference: np.ndarray) -> float:
    """
    TM-score of query CA trace vs reference CA trace, normalized by reference
    length. Unequal lengths use gapless threading (best contiguous offset).
    """
    query = np.asarray(query, dtype=np.float64)
    reference = np.asarray(reference, dtype=np.float64)
    lq, lr = len(query), len(reference)
    if lq == 0 or lr == 0:
        return float("nan")
    if lq == lr:
        return _tm_score_aligned(query, reference, lr)
    best = -1.0
    if lq > lr:
        for off in range(lq - lr + 1):
            best = max(best, _tm_score_aligned(query[off : off + lr], reference, lr))
    else:
        for off in range(lr - lq + 1):
            best = max(best, _tm_score_aligned(query, reference[off : off + lq], lr))
    return best


def _load_ca(pdb_file: str) -> Optional[np.ndarray]:
    from foldingdiff_tpu_torch.geometry.pdb import extract_backbone_coords

    try:
        coords = extract_backbone_coords(pdb_file, atoms=("CA",))
    except (OSError, ValueError):
        return None
    if coords is None or len(coords) < 3:
        return None
    return coords


def run_tmalign(query: str, reference: str, fast: bool = False) -> float:
    """
    File-level TM-score (reference tmalign.run_tmalign API, tmalign.py:22-54).
    Prefers the C++ TM-align; falls back to the numpy threading
    implementation. fast=True uses the truncated screening-grade search (the
    analogue of TM-align's -fast flag the reference passes for big
    max-over-references sweeps, tmalign.py:36-37). Returns NaN on failure.
    """
    if tmalign_native.available():
        return tmalign_native.run_tmalign(query, reference, fast=fast)
    q = _load_ca(query)
    r = _load_ca(reference)
    if q is None or r is None:
        logging.warning(f"TM-score failed for {query} vs {reference}")
        return float("nan")
    return tm_score(q, r)


def max_tm_across_refs(
    query: str,
    references: List[str],
    n_threads: int = int(os.environ.get("FOLDINGDIFF_TM_THREADS", max(1, (os.cpu_count() or 1)))),
    fast: bool = True,
    chunksize: int = 10,
    parallel: bool = True,
    rescore_top_k: int = 5,
) -> Tuple[float, str]:
    """
    Max TM-score of query against each reference (reference tmalign.py:57-83;
    like the reference, the sweep runs in fast mode by default). The top
    rescore_top_k fast candidates are re-scored with the FULL alignment and
    that max is reported, so the score has full accuracy while the O(n_refs)
    sweep stays fast (0 disables re-scoring). The pool's workers are spawned.
    """
    logging.debug(f"Matching against {len(references)} references using {n_threads} threads")
    args = [(query, str(r), fast) for r in references]
    if parallel and n_threads > 1 and len(references) > 1:
        with mp.get_context("spawn").Pool(n_threads) as pool:
            values = pool.starmap(run_tmalign, args, chunksize=chunksize)
    else:
        values = [run_tmalign(*a) for a in args]
    values = np.array(values, dtype=float)
    if np.all(np.isnan(values)):
        return float("nan"), ""
    if fast and rescore_top_k > 0:
        top = np.argsort(np.nan_to_num(values, nan=-1.0))[::-1][:rescore_top_k]
        rescored = [(run_tmalign(query, str(references[i]), fast=False), int(i)) for i in top]
        rescored = [(s, i) for s, i in rescored if not np.isnan(s)]
        if rescored:
            score, best = max(rescored)
            return float(score), str(references[best])
    best = int(np.nanargmax(values))
    return float(values[best]), str(references[best])


def match_files(
    queries: Sequence[str], references: Sequence[str]
) -> List[Tuple[str, List[str]]]:
    """
    Pair each query with references sharing its basename stem (exact, prefix,
    or suffix match) -- reference tmalign.match_files (tmalign.py:86-112).
    """
    get_stem = lambda f: os.path.splitext(os.path.basename(f))[0]
    retval = []
    for q in queries:
        qs = get_stem(q)
        matches = [
            r
            for r in references
            if get_stem(r) == qs or get_stem(r).startswith(qs) or get_stem(r).endswith(qs)
        ]
        retval.append((q, matches))
    return retval


def score_reconstruction(
    recon: np.ndarray, truth: np.ndarray, truth_pdb: str, ft_names: Sequence[str]
) -> Tuple[float, float]:
    """
    (TM of the reconstructed against the true angles, each built by NeRF;
    TM of the reconstruction against the original PDB file). NaN where a
    build fails. Host numpy only: a process pool's workers may run it.
    """
    from foldingdiff_tpu_torch.geometry.featurize import create_new_chain_nerf

    with tempfile.TemporaryDirectory() as td:
        truth_out = create_new_chain_nerf(os.path.join(td, "truth.pdb"), truth, ft_names)
        recon_out = create_new_chain_nerf(os.path.join(td, "recon.pdb"), recon, ft_names)
        if not truth_out or not recon_out:
            return float("nan"), float("nan")
        score = run_tmalign(recon_out, truth_out)
        score_coord = run_tmalign(recon_out, truth_pdb) if truth_pdb else float("nan")
    return score, score_coord
