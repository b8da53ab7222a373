"""
PDB backbone I/O (counterpart of foldingdiff_tpu/geometry/pdb.py), numpy
only, by fixed-column parsing in place of the reference's biotite
(angles_and_coords.py:17-19, 41-49, 187-253):
- read the N/CA/C atoms of each residue (first model, first altloc, amino
  acids only);
- write GLY-only N/CA/C backbones in the style of the reference
  write_coords_to_pdb (chain A, occupancy 1.0, b-factor 5.0), and GLY
  CA traces for cart-coords models (write_ca_trace_to_pdb).
"""
from __future__ import annotations

import gzip
import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# The 20 standard residues plus common variants biotite treats as amino acids
AMINO_ACIDS = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "MSE", "SEC", "PYL", "UNK", "ASX", "GLX",
}

BACKBONE_ATOMS = ("N", "CA", "C")


@dataclass
class PDBAtom:
    name: str
    element: str
    res_name: str
    res_id: int
    chain_id: str
    coord: np.ndarray
    hetero: bool = False
    insertion: str = ""
    altloc: str = ""


@dataclass
class PDBStructure:
    atoms: List[PDBAtom] = field(default_factory=list)
    model_count: int = 1

    def _backbone_atoms(self) -> List[PDBAtom]:
        return [a for a in self.atoms
                if (not a.hetero) and a.name in BACKBONE_ATOMS and a.res_name in AMINO_ACIDS]

    def backbone_coords(self) -> np.ndarray:
        """
        (3N, 3) array of N/CA/C coords in atom-record order, amino acids only,
        matching biotite filter_backbone semantics (name in N/CA/C, amino acid,
        non-hetero).
        """
        coords = [a.coord for a in self._backbone_atoms()]
        return np.stack(coords) if coords else np.zeros((0, 3))

    def atom_coords(self, names=("CA",)) -> np.ndarray:
        """Coords of the named backbone atoms, in order (reference extract_backbone_coords)."""
        bb = self._backbone_atoms()
        return np.stack([a.coord for a in bb if a.name in names]) if bb else np.zeros((0, 3))


def _open_maybe_gz(fname: str):
    return gzip.open(fname, "rt") if str(fname).endswith(".gz") else open(fname, "rt")


def read_pdb(fname: str, keep_hetero: bool = False) -> PDBStructure:
    """
    Parse a PDB file's first model, by the fixed columns of the PDB v3.3
    spec. The first record of each (chain, residue, insertion code, atom
    name) wins, which keeps the first altloc variant.
    """
    if not os.path.isfile(fname):
        raise FileNotFoundError(f"Missing file: {fname}")
    atoms: List[PDBAtom] = []
    model_count = 0
    in_first_model = True
    seen = set()
    with _open_maybe_gz(fname) as fh:
        for line in fh:
            rec = line[:6]
            if rec == "MODEL ":
                model_count += 1
                in_first_model = model_count <= 1
                continue
            if rec == "ENDMDL" or not in_first_model:
                continue
            is_atom = rec == "ATOM  "
            is_het = rec == "HETATM"
            if not (is_atom or (is_het and keep_hetero)):
                continue
            name = line[12:16].strip()
            altloc = line[16].strip()
            res_name = line[17:20].strip()
            chain_id = line[21].strip()
            try:
                res_id = int(line[22:26])
            except ValueError:
                continue
            insertion = line[26].strip()
            key = (chain_id, res_id, insertion, name)
            if key in seen:
                continue
            seen.add(key)
            try:
                coord = np.array([float(line[30:38]), float(line[38:46]), float(line[46:54])], dtype=np.float64)
            except ValueError:
                continue
            atoms.append(PDBAtom(
                name=name, element=line[76:78].strip() or name[:1], res_name=res_name, res_id=res_id,
                chain_id=chain_id, coord=coord, hetero=is_het, insertion=insertion, altloc=altloc,
            ))
    return PDBStructure(atoms=atoms, model_count=max(model_count, 1))


def get_model_count(fname: str) -> int:
    """Number of MODEL records (0 and 1 both mean a single model)."""
    with _open_maybe_gz(fname) as fh:
        count = sum(line.startswith("MODEL ") for line in fh)
    return max(count, 1)


def get_pdb_length(fname: str) -> int:
    """
    Chain length in residues (backbone atom count / 3); -1 for multi-model
    files (reference angles_and_coords.py:256-268).
    """
    struct = read_pdb(fname)
    if struct.model_count > 1:
        return -1
    return int(len(struct.backbone_coords()) // 3)


def extract_backbone_coords(fname: str, atoms=("CA",)) -> Optional[np.ndarray]:
    """The named backbone atoms' coords, in order; None for multi-model files
    (reference angles_and_coords.extract_backbone_coords)."""
    struct = read_pdb(fname)
    if struct.model_count > 1:
        return None
    return struct.atom_coords(names=tuple(atoms))


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


def write_ca_trace_to_pdb(coords: np.ndarray, out_fname: str) -> str:
    """
    Write an (L, 3) CA coordinate array as a GLY CA-trace PDB: the output of
    a cart-coords model, whose samples are CA positions, not angles.

    The coordinates are zero-centred first. A coordinate whose magnitude
    still reaches 1000 A (or is not finite) overflows the fixed %8.3f
    columns, so it raises ValueError rather than write a PDB whose shifted
    columns TM-align or DSSP would misread.
    """
    coords = np.asarray(coords, dtype=np.float64)
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"Expected (L, 3) coords, got {coords.shape}")
    coords = coords - coords.mean(axis=0)
    if not np.all(np.abs(coords) < 1000.0):
        raise ValueError(
            f"CA coords exceed PDB %8.3f column width even after recentering "
            f"(max |coord| = {np.abs(coords).max():.1f} A); refusing to write {out_fname}"
        )
    with _atomic_write(out_fname) as fh:
        for i, c in enumerate(coords):
            fh.write(_format_atom_line(i + 1, "CA", "GLY", "A", i + 1, c, 1.0, 5.0, "C"))
        fh.write("END\n")
    return out_fname
