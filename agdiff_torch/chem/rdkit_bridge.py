"""RDKit interop on the host (port of agdiff_tpu/chem/rdkit_bridge.py;
reference call sites: src/agdiff/utils/chem.py, datasets.py:326-380,
smiles_generation.py:253-284, covmat.py:26-28).

RDKit is optional: training, sampling and COV/MAT run without it (the
symmetry-aware RMSD is chem/rmsd.py and native/rmsd.cpp). This module is
what needs it: parsing molecules, SMILES round trips, ETKDG embedding,
MMFF relaxation, SDF export and 2-D depictions. RDKit is imported inside
each function, so that agdiff_torch imports with torch alone; each
function raises ImportError naming RDKit where it is not installed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from agdiff_torch.chem.mol import Molecule

MISSING = ("RDKit is required for this operation (pip install rdkit); "
           "training, sampling and COV/MAT evaluation work without it")


def _chem():
    """rdkit.Chem, or ImportError naming RDKit."""
    try:
        from rdkit import Chem
    except ImportError as err:
        raise ImportError(MISSING) from err
    return Chem


def require_rdkit() -> None:
    """Raise ImportError naming RDKit unless it can be imported: the
    entry points that reach RDKit later (GEOM preprocessing, the force
    field of COV/MAT) call it first, so that they fail before any work."""
    _chem()


def rdmol_to_molecule(mol, smiles: Optional[str] = None) -> Molecule:
    """An RDKit Mol with one conformer -> Molecule, as the reference's
    rdmol_to_data (datasets.py:326-380): both directions of each bond in
    row-major order, hydrogens kept, bond types by RDKit's BondType
    index."""
    Chem = _chem()
    if mol.GetNumConformers() != 1:
        raise ValueError(f"expected one conformer, got "
                         f"{mol.GetNumConformers()}")
    n = mol.GetNumAtoms()
    pos = np.asarray(mol.GetConformer(0).GetPositions(), np.float32)
    z = np.array([a.GetAtomicNum() for a in mol.GetAtoms()], np.int32)
    row, col, etype = [], [], []
    for bond in mol.GetBonds():
        start, end = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        t = int(bond.GetBondType())
        row += [start, end]
        col += [end, start]
        etype += [t, t]
    order = np.argsort(np.array(row) * n + np.array(col))
    if smiles is None:
        smiles = Chem.MolToSmiles(mol)
    return Molecule(
        atom_type=z, pos=pos,
        bond_index=np.stack([np.array(row)[order], np.array(col)[order]]),
        bond_type=np.array(etype, np.int32)[order], smiles=smiles)


def molecule_to_rdmol(mol: Molecule, pos: Optional[np.ndarray] = None):
    """Molecule -> RDKit Mol with one conformer (SDF export, MMFF)."""
    Chem = _chem()
    from rdkit.Chem.rdchem import BondType

    rw = Chem.RWMol()
    for z in mol.atom_type:
        rw.AddAtom(Chem.Atom(int(z)))
    pairs, types = mol.undirected_bonds()
    for (i, j), t in zip(pairs, types):
        rw.AddBond(int(i), int(j), BondType.values[int(t)])
    m = rw.GetMol()
    conf = Chem.Conformer(mol.num_nodes)
    p = mol.pos if pos is None else np.asarray(pos)
    for i in range(mol.num_nodes):
        conf.SetAtomPosition(i, [float(x) for x in p[i]])
    m.AddConformer(conf)
    try:
        Chem.SanitizeMol(m)
    except Exception:  # RDKit raises several kinds; geometry needs no
        pass           # valid valence
    return m


def smiles_to_molecule(smiles: str, seed: int = 2021) -> Molecule:
    """SMILES -> AddHs -> ETKDGv3 embedding -> Molecule (reference:
    smiles_generation.py:253-284); random starting coordinates where the
    embedding fails, as the JAX package does (the reference raises)."""
    Chem = _chem()
    from rdkit.Chem import AllChem

    m = Chem.MolFromSmiles(smiles)
    if m is None:
        raise ValueError(f"cannot parse SMILES: {smiles}")
    m = Chem.AddHs(m)
    params = AllChem.ETKDGv3()
    params.randomSeed = seed
    if AllChem.EmbedMolecule(m, params) != 0:
        AllChem.EmbedMolecule(m, useRandomCoords=True, randomSeed=seed)
    return rdmol_to_molecule(m, smiles=smiles)


def mmff_optimize_positions(mol: Molecule, pos: np.ndarray) -> np.ndarray:
    """MMFF94 relaxation of one conformation (reference covmat.py:26-28,
    useFF); the positions unchanged where MMFF cannot type the
    molecule."""
    _chem()
    from rdkit.Chem.rdForceFieldHelpers import MMFFOptimizeMolecule

    m = molecule_to_rdmol(mol, pos)
    try:
        MMFFOptimizeMolecule(m)
    except Exception:  # MMFF raises several kinds on untyped atoms
        return np.asarray(pos, np.float32)
    return np.asarray(m.GetConformer(0).GetPositions(), np.float32)


def rdkit_best_rmsd(ref_mol, gen_mol) -> float:
    """RDKit's GetBestRMS on copies without hydrogens (the reference
    metric, chem.py:133-137), to hold chem/rmsd.py against."""
    _chem()
    from rdkit.Chem import rdMolAlign
    from rdkit.Chem.rdmolops import RemoveHs

    return float(rdMolAlign.GetBestRMS(RemoveHs(gen_mol), RemoveHs(ref_mol)))


def write_sdf(path: str, mol: Molecule, conformers: np.ndarray) -> None:
    """Conformers of `mol` to an SDF file, one record each (reference:
    smiles_generation.py:409-445)."""
    Chem = _chem()
    writer = Chem.SDWriter(path)
    try:
        for pos in np.asarray(conformers).reshape(-1, mol.num_nodes, 3):
            writer.write(molecule_to_rdmol(mol, pos))
    finally:
        writer.close()


def mol_to_smiles(rdmol) -> str:
    """Canonical SMILES without hydrogens (reference chem.py:74-75)."""
    Chem = _chem()
    return Chem.MolToSmiles(Chem.RemoveHs(rdmol))


def smiles_to_canonical(smiles: str) -> str:
    return _chem().CanonSmiles(smiles)


def draw_mol_image(rdmol, tensor: bool = False):
    """2-D depiction (reference chem.py:27-33): a PIL image, or with
    tensor=True a (C, H, W) float32 torch tensor in [0, 1]."""
    _chem()
    from rdkit.Chem import Draw

    rdmol.UpdatePropertyCache()
    img = Draw.MolToImage(rdmol, kekulize=False)
    if tensor:
        import torch

        arr = np.asarray(img, np.float32) / 255.0
        return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))
    return img
