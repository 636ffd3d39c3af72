"""Test-set datasets (port of agdiff_tpu/data/dataset.py:30-109, the
generation side).

ConformationDataset holds one entry per conformer; PackedConformationDataset
one per molecule, its reference conformers stacked in pos_ref (packed by
SMILES, or by meta['idx'], in first-seen order, as the reference packs,
datasets.py:1043-1061). Both read the .npz molecule format of
chem/mol.save_molecules. The reference's .pkl files need RDKit and the
port of agdiff_tpu/data/geom.py (ROADMAP, queue 1), and raise here.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from agdiff_torch.chem.mol import Molecule, load_molecules


def _load_any(path: str) -> List[Molecule]:
    if path.endswith(".npz"):
        return load_molecules(path)
    if path.endswith(".pkl"):
        raise NotImplementedError(
            "reading the reference's .pkl datasets needs RDKit and the port "
            "of agdiff_tpu/data/geom.py (ROADMAP.md, queue 1: the GEOM "
            "pickle loader); convert the set to .npz with the JAX package's "
            "save_molecules")
    raise ValueError(f"Unknown dataset format: {path}")


class ConformationDataset:
    """One entry per conformer."""

    def __init__(self, source, transform=None):
        self.molecules = (_load_any(source) if isinstance(source, str)
                          else list(source))
        self.transform = transform
        self.atom_types = sorted(
            {int(a) for m in self.molecules for a in np.unique(m.atom_type)})
        self.edge_types = sorted(
            {int(t) for m in self.molecules for t in np.unique(m.bond_type)})

    def __len__(self) -> int:
        return len(self.molecules)

    def __getitem__(self, idx: int) -> Molecule:
        mol = self.molecules[idx]
        return mol if self.transform is None else self.transform(mol)

    def max_num_nodes(self) -> int:
        return max(m.num_nodes for m in self.molecules)


class PackedConformationDataset(ConformationDataset):
    """One entry per molecule, pos_ref holding its reference conformers;
    per-conformer molecules are packed on load."""

    def __init__(self, source, transform=None):
        super().__init__(source, transform)
        if self.molecules and self.molecules[0].pos_ref is None:
            self.molecules = _pack(self.molecules)

    def num_refs(self, idx: int) -> int:
        return self.molecules[idx].num_ref


def _pack(mols: List[Molecule]) -> List[Molecule]:
    by_key: Dict[str, List[Molecule]] = {}
    for m in mols:
        by_key.setdefault(m.smiles or str(m.meta.get("idx", id(m))),
                          []).append(m)
    return [Molecule(atom_type=g[0].atom_type, pos=g[0].pos,
                     bond_index=g[0].bond_index, bond_type=g[0].bond_type,
                     pos_ref=np.concatenate([x.pos for x in g], axis=0),
                     smiles=g[0].smiles, meta=dict(g[0].meta))
            for g in by_key.values()]
