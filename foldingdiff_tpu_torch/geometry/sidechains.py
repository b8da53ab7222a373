"""
Idealized side chains and backbone oxygens on the host (counterpart of
foldingdiff_tpu/geometry/sidechains.py; reference
angles_and_coords.py:287-434 and bin/add_oxygen_to_backbone.py:42-83).

Each side-chain atom is described relative to its residue's N/CA/C frame as
(distance to C, angle at C against CA, dihedral N-CA-C-atom), collected
from the repository's reference PDBs (data/*.pdb), then rebuilt on any
backbone with place_dihedral_np. numpy only.
"""
from __future__ import annotations

import functools
import logging
from collections import defaultdict, namedtuple
from itertools import groupby
from pathlib import Path
from typing import Collection, Dict, List, Optional

import numpy as np

from foldingdiff_tpu_torch.geometry.featurize import bond_angle_np, dihedral_np
from foldingdiff_tpu_torch.geometry.nerf import place_dihedral_np
from foldingdiff_tpu_torch.geometry.pdb import PDBAtom, read_pdb, write_full_atoms_to_pdb

SideChainAtomRelative = namedtuple(
    "SideChainAtom", ["name", "element", "bond_dist", "bond_angle", "dihedral_angle"]
)

AA_3TO1 = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q",
    "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K",
    "MET": "M", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRP": "W",
    "TYR": "Y", "VAL": "V",
}
AA_1TO3 = {v: k for k, v in AA_3TO1.items()}

DATA_DIR = Path(__file__).resolve().parents[2] / "data"


def _group_residues(atoms: List[PDBAtom]):
    return groupby(atoms, key=lambda a: (a.chain_id, a.res_id, a.insertion))


def collect_aa_sidechain_angles(ref_fname: str) -> Dict[str, List[SideChainAtomRelative]]:
    """The relative side-chain geometry of the first residue of each type in
    a single-model reference PDB (reference angles_and_coords.py:301-349)."""
    struct = read_pdb(ref_fname)
    if struct.model_count > 1:
        raise ValueError(f"Multi-model file: {ref_fname}")
    retval: Dict[str, List[SideChainAtomRelative]] = defaultdict(list)
    for _, res_atoms in _group_residues(struct.atoms):
        res_atoms = list(res_atoms)
        res_name = res_atoms[0].res_name
        if res_name not in AA_3TO1:
            logging.debug(f"{ref_fname}: skipping unknown residue {res_name}")
            continue
        residue = AA_3TO1[res_name]
        if residue in retval:
            continue
        backbone = {a.name: a.coord for a in res_atoms if a.name in ("N", "CA", "C")}
        if len(backbone) != 3:
            continue
        a, b, c = backbone["N"], backbone["CA"], backbone["C"]
        for atom in res_atoms:
            if atom.name in ("N", "CA", "C"):
                continue
            d = atom.coord
            retval[residue].append(SideChainAtomRelative(
                name=atom.name, element=atom.element, bond_dist=float(np.linalg.norm(d - c)),
                bond_angle=float(bond_angle_np(d, c, b)), dihedral_angle=float(dihedral_np(a, b, c, d)),
            ))
    logging.info(f"Collected {len(retval)} residue side-chain geometries from {ref_fname}")
    return dict(retval)


@functools.lru_cache(maxsize=32)
def build_aa_sidechain_dict(reference_pdbs: Optional[tuple] = None) -> Dict[str, List[SideChainAtomRelative]]:
    """The side-chain geometry library over reference PDBs, data/*.pdb by
    default, later files overriding earlier ones per residue type; files
    with several models are skipped (reference angles_and_coords.py:352-375)."""
    if not reference_pdbs:
        reference_pdbs = tuple(sorted(str(p) for p in DATA_DIR.glob("*.pdb")))
    retval: Dict[str, List[SideChainAtomRelative]] = {}
    n_used = 0
    for pdb in reference_pdbs:
        try:
            retval.update(collect_aa_sidechain_angles(pdb))
            n_used += 1
        except ValueError:
            continue
    logging.info(f"Built side-chain dictionary with {len(retval)} amino acids from {n_used} files")
    return retval


def add_sidechains_to_backbone(backbone_pdb_fname: str, aa_seq: str, out_fname: str,
                               reference_pdbs: Optional[Collection[str]] = None) -> str:
    """Graft the idealized side chains of aa_seq (one letter per residue,
    at most the backbone's length) onto an N/CA/C backbone PDB (reference
    angles_and_coords.py:378-434)."""
    struct = read_pdb(backbone_pdb_fname)
    if struct.model_count > 1:
        raise ValueError(f"Multi-model file: {backbone_pdb_fname}")
    aa_library = build_aa_sidechain_dict(tuple(reference_pdbs) if reference_pdbs else None)

    full_atoms: List[PDBAtom] = []
    residues = [list(atoms) for _, atoms in _group_residues(struct.atoms)]
    if len(aa_seq) > len(residues):
        raise ValueError(f"{len(aa_seq)} residues in the sequence vs {len(residues)} in the backbone")
    for res_aa, backbone_atoms in zip(aa_seq, residues):
        bb = [a for a in backbone_atoms if a.name in ("N", "CA", "C")]
        if len(bb) != 3:
            raise ValueError(f"Expected a pure N/CA/C backbone, got {[a.name for a in backbone_atoms]}")
        res3 = AA_1TO3[res_aa]
        for b_at in bb:
            full_atoms.append(PDBAtom(name=b_at.name, element=b_at.element, res_name=res3, res_id=b_at.res_id,
                                      chain_id=b_at.chain_id, coord=b_at.coord))
        a, b, c = (x.coord for x in bb)
        for rel in aa_library[res_aa]:
            d = place_dihedral_np(a, b, c, rel.bond_angle, rel.bond_dist, rel.dihedral_angle)
            full_atoms.append(PDBAtom(name=rel.name, element=rel.element, res_name=res3, res_id=bb[0].res_id,
                                      chain_id=bb[0].chain_id, coord=np.asarray(d)))
    return write_full_atoms_to_pdb(full_atoms, out_fname)


def add_oxygen_to_backbone(backbone_pdb_fname: str, out_fname: str) -> str:
    """
    Place the carbonyl O of each residue of an N/CA/C backbone (reference
    bin/add_oxygen_to_backbone.py:42-83): off C at the psi dihedral plus pi
    (O eclipses the next N), with ideal C=O geometry (1.23 A, 121 deg); the
    C-terminal residue takes psi = 0.
    """
    struct = read_pdb(backbone_pdb_fname)
    bb = struct.backbone_coords()
    if len(bb) % 3:
        raise ValueError(f"{backbone_pdb_fname}: {len(bb)} backbone atoms, not N/CA/C per residue")
    n_res = len(bb) // 3
    n_at, ca_at, c_at = bb[0::3], bb[1::3], bb[2::3]

    full_atoms: List[PDBAtom] = []
    for i, res_atoms in enumerate(list(atoms) for _, atoms in _group_residues(struct.atoms)):
        full_atoms.extend(res_atoms)
        psi = dihedral_np(n_at[i], ca_at[i], c_at[i], n_at[i + 1]) if i < n_res - 1 else 0.0
        o_coord = place_dihedral_np(n_at[i], ca_at[i], c_at[i], bond_angle=121.0 / 180.0 * np.pi,
                                    bond_length=1.23, torsion_angle=float(psi) + np.pi)
        last = res_atoms[-1]
        full_atoms.append(PDBAtom(name="O", element="O", res_name=last.res_name, res_id=last.res_id,
                                  chain_id=last.chain_id, coord=np.asarray(o_coord)))
    return write_full_atoms_to_pdb(full_atoms, out_fname)
