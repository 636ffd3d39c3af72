"""Minimal PDB reader and writer, no mdtraj or RDKit (port of
agdiff_tpu/chem/pdb.py).

ATOM/HETATM records with their residue annotations, CONECT bonds, and
covalent-radius bond perception where a file has no CONECT records; the
writer emits one or more conformations as a (multi-MODEL) PDB, the
replacement of the reference's mdtraj export. Host numpy: the protein
path's input (data/protein.py, examples/alanine_dipeptide.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from agdiff_torch.chem.constants import ATOM_SYMBOLS, ATOMIC_NUMBERS, BondType
from agdiff_torch.chem.mol import Molecule

# single-bond covalent radii (Angstrom), Pyykko & Atsumi, rounded; other
# elements take 0.8
COVALENT_RADIUS = {
    1: 0.32, 5: 0.85, 6: 0.75, 7: 0.71, 8: 0.63, 9: 0.64, 14: 1.16,
    15: 1.11, 16: 1.03, 17: 0.99, 35: 1.14, 53: 1.33,
}
BACKBONE_NAMES = frozenset({"N", "CA", "C", "O"})


def element_of(line: str) -> Optional[int]:
    """The atomic number of an ATOM/HETATM line: its element columns
    (77-78), else the atom name's (13-16) first two letters when they
    name an element, else its first letter; None for an unknown
    element."""
    elem = line[76:78].strip() if len(line) >= 78 else ""
    if not elem:
        name = line[12:16].strip()
        two = name[:2].capitalize()
        elem = two if two in ATOMIC_NUMBERS else name[:1].upper()
    return ATOMIC_NUMBERS.get(elem.capitalize())


def directed_bonds(bonds, n: int) -> np.ndarray:
    """(2, 2E) bond_index of a set of bonds (i, j) among n atoms: each
    bond both ways, sorted by (source, destination)."""
    src, dst = [], []
    for i, j in sorted(bonds):
        src += [i, j]
        dst += [j, i]
    if not src:
        return np.zeros((2, 0), np.int32)
    src, dst = np.array(src), np.array(dst)
    order = np.argsort(src * n + dst)
    return np.stack([src[order], dst[order]])


def parse_pdb(text: str) -> Tuple[Molecule, Dict[str, np.ndarray]]:
    """PDB text -> (Molecule, per-atom annotations: atom_name, res_name,
    res_id, is_backbone, is_sidechain, is_alpha). Bonds come from CONECT
    records, or, where there are none, from perceive_bonds; every bond is
    SINGLE."""
    serials: Dict[int, int] = {}
    atom_type: List[int] = []
    pos: List[List[float]] = []
    names, res_names, res_ids = [], [], []
    conect: List[Tuple[int, int]] = []
    for line in text.splitlines():
        rec = line[:6].strip()
        if rec in ("ATOM", "HETATM"):
            z = element_of(line)
            if z is None:
                continue
            serials[int(line[6:11])] = len(atom_type)
            atom_type.append(z)
            pos.append([float(line[30:38]), float(line[38:46]),
                        float(line[46:54])])
            names.append(line[12:16].strip())
            res_names.append(line[17:20].strip())
            res_ids.append(int(line[22:26]))
        elif rec == "CONECT":
            fields = [int(line[k:k + 5])
                      for k in range(6, min(len(line), 31), 5)
                      if line[k:k + 5].strip()]
            conect += [(fields[0], other) for other in fields[1:]]

    atom_type_arr = np.array(atom_type, np.int32)
    pos_arr = np.array(pos, np.float32)
    bonds = {(min(serials[a], serials[b]), max(serials[a], serials[b]))
             for a, b in conect
             if a in serials and b in serials and serials[a] != serials[b]}
    if not bonds:
        bonds = perceive_bonds(atom_type_arr, pos_arr)
    bond_index = directed_bonds(bonds, len(atom_type))
    annotations = {
        "atom_name": np.array(names),
        "res_name": np.array(res_names),
        "res_id": np.array(res_ids, np.int32),
        "is_backbone": np.array([nm in BACKBONE_NAMES for nm in names]),
        "is_sidechain": np.array([nm not in BACKBONE_NAMES and z != 1
                                  for nm, z in zip(names, atom_type)]),
        "is_alpha": np.array([nm == "CA" for nm in names]),
    }
    mol = Molecule(
        atom_type=atom_type_arr, pos=pos_arr, bond_index=bond_index,
        bond_type=np.full(bond_index.shape[1], int(BondType.SINGLE),
                          np.int32))
    return mol, annotations


def perceive_bonds(atom_type: np.ndarray, pos: np.ndarray,
                   tolerance: float = 0.45) -> set:
    """{(i, j), i < j}: atoms closer than their covalent radii plus
    `tolerance`, and farther apart than 0.4 A."""
    dist = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    radii = np.array([COVALENT_RADIUS.get(int(z), 0.8) for z in atom_type])
    thresh = radii[:, None] + radii[None, :] + tolerance
    ii, jj = np.nonzero((dist < thresh) & (dist > 0.4))
    return {(int(i), int(j)) for i, j in zip(ii, jj) if i < j}


def load_pdb(path: str) -> Tuple[Molecule, Dict[str, np.ndarray]]:
    with open(path) as f:
        return parse_pdb(f.read())


def write_pdb(path: str, mol: Molecule, conformers: np.ndarray,
              annotations: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write one or more conformations (K, N, 3) of `mol` as a PDB file:
    MODEL/ENDMDL blocks when there are several, atom and residue names
    from `annotations` (else the element and UNK 1)."""
    confs = np.asarray(conformers, np.float32).reshape(-1, mol.num_nodes, 3)
    ann = annotations or {}
    names = ann.get("atom_name")
    res_names = ann.get("res_name")
    res_ids = ann.get("res_id")
    multi = len(confs) > 1
    with open(path, "w") as f:
        for m, pos in enumerate(confs, start=1):
            if multi:
                f.write(f"MODEL     {m:4d}\n")
            for i in range(mol.num_nodes):
                sym = ATOM_SYMBOLS.get(int(mol.atom_type[i]), "X")
                name = names[i] if names is not None else sym
                rn = res_names[i] if res_names is not None else "UNK"
                ri = int(res_ids[i]) if res_ids is not None else 1
                f.write(
                    "ATOM  %5d %-4s %-3s A%4d    %8.3f%8.3f%8.3f  1.00  0.00"
                    "          %2s\n"
                    % (i + 1, name[:4], rn[:3], ri, pos[i, 0], pos[i, 1],
                       pos[i, 2], sym))
            if multi:
                f.write("ENDMDL\n")
        f.write("END\n")

