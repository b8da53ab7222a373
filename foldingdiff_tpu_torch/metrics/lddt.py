"""
lDDT, the local Distance Difference Test (Mariani et al., Bioinformatics
2013), counterpart of foldingdiff_tpu/metrics/lddt.py; the reference shells
out to OpenStructure in docker (foldingdiff/lddt.py:32-56).

Over the atom pairs of DIFFERENT residues within the inclusion radius
(15 A) in the REFERENCE structure, the share whose model distance deviates
by less than each threshold in {0.5, 1, 2, 4} A, averaged over the
thresholds.

- `lddt_np`: one structure on the host, float64.
- `lddt_torch`: a batch on the tensors' own device (the counterpart of the
  JAX package's XLA function `lddt_jax`), in the inputs' dtype.
- `lddt_pdb` / `lddt_sampled_folded`: the file-level API. By default every
  backbone atom present in both structures (N/CA/C, and O where present) is
  scored and same-residue pairs are left out by a per-atom residue index,
  the reference's OpenStructure convention; atoms=("CA",) scores the CA
  trace.
"""
from __future__ import annotations

import json
import logging
import multiprocessing
import os
from collections import defaultdict
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
INCLUSION_RADIUS = 15.0
BACKBONE_ATOM_NAMES = ("N", "CA", "C", "O")


def lddt_np(
    model: np.ndarray,
    reference: np.ndarray,
    thresholds: Sequence[float] = THRESHOLDS,
    inclusion_radius: float = INCLUSION_RADIUS,
    per_residue: bool = False,
    residue_index: Optional[np.ndarray] = None,
):
    """
    lDDT of (N, 3) model coords against (N, 3) reference coords.

    residue_index: (N,) per-atom residue ids; pairs within one residue are
    left out. Default: each atom is its own residue (the CA trace).
    per_residue: an array of scores, one per residue id in sorted order
    (NaN for a residue with no included pair), in place of one float.
    """
    model = np.asarray(model, dtype=np.float64)
    reference = np.asarray(reference, dtype=np.float64)
    if model.shape != reference.shape or model.ndim != 2:
        raise ValueError(f"model {model.shape} and reference {reference.shape} must both be (N, 3)")
    n = len(model)
    residue_index = np.arange(n) if residue_index is None else np.asarray(residue_index)
    if residue_index.shape != (n,):
        raise ValueError(f"residue_index {residue_index.shape}, expected ({n},)")

    dref = np.linalg.norm(reference[:, None, :] - reference[None, :, :], axis=-1)
    dmod = np.linalg.norm(model[:, None, :] - model[None, :, :], axis=-1)
    diff_res = residue_index[:, None] != residue_index[None, :]
    incl = (dref < inclusion_radius) & diff_res
    delta = np.abs(dref - dmod)
    preserved = np.zeros_like(dref)
    for thr in thresholds:
        preserved += (delta < thr).astype(np.float64)
    preserved /= len(thresholds)
    if per_residue:
        res_ids = np.unique(residue_index)
        out = np.full(len(res_ids), np.nan)
        for k, r in enumerate(res_ids):
            rows = residue_index == r
            tot = incl[rows].sum()
            if tot > 0:
                out[k] = (preserved[rows] * incl[rows]).sum() / tot
        return out
    total = incl.sum()
    if total == 0:
        return float("nan")
    return float((preserved * incl).sum() / total)


def lddt_torch(
    model: "torch.Tensor",
    reference: "torch.Tensor",
    thresholds: Sequence[float] = THRESHOLDS,
    inclusion_radius: float = INCLUSION_RADIUS,
    residue_index: Optional["torch.Tensor"] = None,
) -> "torch.Tensor":
    """
    Batched lDDT on the tensors' device: model and reference (B, N, 3),
    residue_index None (each atom its own residue), (N,) or (B, N). Returns
    (B,) in the inputs' dtype; a structure with no included pair scores 0.
    Distances are sqrt(max(d.d, 1e-12)), as the JAX package's lddt_jax.
    torch is imported here, so the file API's spawned pool workers, which
    import this module, start without it.
    """
    import torch

    if model.shape != reference.shape or model.ndim != 3:
        raise ValueError(f"model {tuple(model.shape)} and reference {tuple(reference.shape)} must both be (B, N, 3)")

    def pdists(x):
        d = x[:, :, None, :] - x[:, None, :, :]
        return torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-12))

    dref, dmod = pdists(reference), pdists(model)
    n = model.shape[1]
    if residue_index is None:
        diff_res = ~torch.eye(n, dtype=torch.bool, device=model.device)[None]
    else:
        ri = torch.as_tensor(residue_index, device=model.device)
        ri = ri[None] if ri.ndim == 1 else ri
        diff_res = ri[:, :, None] != ri[:, None, :]
    incl = (dref < inclusion_radius) & diff_res
    delta = (dref - dmod).abs()
    preserved = sum((delta < thr).to(model.dtype) for thr in thresholds) / len(thresholds)
    total = incl.sum(dim=(1, 2)).clamp(min=1).to(model.dtype)
    return (preserved * incl).sum(dim=(1, 2)) / total


def _load_backbone_atoms(pdb_file: str, atom_names: Sequence[str]) -> Optional[Tuple[np.ndarray, np.ndarray, list]]:
    """(coords (M, 3), residue_index (M,), atom names) of the amino-acid,
    non-hetero atoms with the given names, residues numbered in file order;
    None for a file that does not parse or holds none."""
    from foldingdiff_tpu_torch.geometry.pdb import AMINO_ACIDS, read_pdb

    try:
        struct = read_pdb(str(pdb_file))
    except (OSError, ValueError) as e:
        logging.error(f"Failed to parse {pdb_file}: {e}")
        return None
    keys, coords, names = [], [], []
    res_order: dict = {}
    for a in struct.atoms:
        if a.hetero or a.res_name not in AMINO_ACIDS or a.name not in atom_names:
            continue
        rk = (a.chain_id, a.res_id, a.insertion)
        if rk not in res_order:
            res_order[rk] = len(res_order)
        keys.append(res_order[rk])
        coords.append(a.coord)
        names.append(a.name)
    if not coords:
        return None
    return np.stack(coords), np.asarray(keys), names


def lddt_pdb(query, ref, atoms: Sequence[str] = BACKBONE_ATOM_NAMES) -> float:
    """
    lDDT of the query PDB against the reference PDB (reference lddt(),
    lddt.py:32-56); -1.0 on failure. Residues pair by position; each side
    scores the per-residue intersection of the atom names present.
    """
    q = _load_backbone_atoms(str(query), atoms)
    r = _load_backbone_atoms(str(ref), atoms)
    if q is None or r is None:
        logging.error(f"Failed to compute lDDT for {query} and {ref}")
        return -1.0
    qc, qres, qnames = q
    rc, rres, rnames = r
    n_res = min(qres.max() + 1, rres.max() + 1)
    q_by_res = [dict() for _ in range(n_res)]
    r_by_res = [dict() for _ in range(n_res)]
    for c, ri, nm in zip(qc, qres, qnames):
        if ri < n_res:
            q_by_res[ri][nm] = c
    for c, ri, nm in zip(rc, rres, rnames):
        if ri < n_res:
            r_by_res[ri][nm] = c
    mq, mr, res_idx = [], [], []
    for i in range(n_res):
        for nm in atoms:
            if nm in q_by_res[i] and nm in r_by_res[i]:
                mq.append(q_by_res[i][nm])
                mr.append(r_by_res[i][nm])
                res_idx.append(i)
    if len(set(res_idx)) < 3:
        return -1.0
    return lddt_np(np.stack(mq), np.stack(mr), residue_index=np.asarray(res_idx))


def lddt_sampled_folded(
    sampled_dir, folded_dir, out_path: str = "lddt.json", atoms: Sequence[str] = BACKBONE_ATOM_NAMES,
    threads: int = 0,
) -> dict:
    """
    For each sampled structure <stem>.pdb, the lDDT of each folded
    <stem>_*.pdb against it (reference lddt.py:59-100). Writes the
    {stem: {folded stem: score}} JSON to out_path and returns it. threads=0
    is every core; more than one thread and more than 4 pairs score in a
    spawned process pool.
    """
    sampled_dir, folded_dir = Path(sampled_dir), Path(folded_dir)
    sampled_pdbs = sorted(sampled_dir.glob("*.pdb"))
    logging.info(f"Found {len(sampled_pdbs)} sampled structures in {sampled_dir}")
    pairs = [(s, folded) for s in sampled_pdbs for folded in sorted(folded_dir.glob(f"{s.stem}_*.pdb"))]
    threads = threads or (os.cpu_count() or 1)
    if threads > 1 and len(pairs) > 4:
        with multiprocessing.get_context("spawn").Pool(threads) as pool:
            scores = pool.starmap(lddt_pdb, [(f, s, atoms) for s, f in pairs], chunksize=4)
    else:
        scores = [lddt_pdb(f, s, atoms=atoms) for s, f in pairs]
    out_dict = defaultdict(dict)
    for (s, folded), score in zip(pairs, scores):
        out_dict[s.stem][folded.stem] = score
    with open(out_path, "w") as sink:
        json.dump(out_dict, sink, indent=4)
    return dict(out_dict)
