"""Host-side molecule (port of agdiff_tpu/chem/mol.py: the fields padding
and generation read, the bond helpers the symmetry-aware RMSD reads,
:67-97, the .npz format, :97-155, which both packages read and write
alike, and the connected components, :158-204)."""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Molecule:
    """One molecular graph.

    atom_type (N,) int32 atomic numbers; pos (N, 3) float32; bond_index
    (2, E) int32 directed edges (each bond in both directions); bond_type
    (E,) int32; pos_ref optional (num_ref * N, 3) stacked reference
    conformers; meta free-form (generation stores `pos_gen` there).
    """

    atom_type: np.ndarray
    pos: np.ndarray
    bond_index: np.ndarray
    bond_type: np.ndarray
    pos_ref: Optional[np.ndarray] = None
    smiles: Optional[str] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.atom_type = np.asarray(self.atom_type, dtype=np.int32)
        self.pos = np.asarray(self.pos, dtype=np.float32).reshape(-1, 3)
        self.bond_index = np.asarray(self.bond_index,
                                     dtype=np.int32).reshape(2, -1)
        self.bond_type = np.asarray(self.bond_type, dtype=np.int32).reshape(-1)
        if self.pos_ref is not None:
            self.pos_ref = np.asarray(self.pos_ref,
                                      dtype=np.float32).reshape(-1, 3)

    @property
    def num_nodes(self) -> int:
        return int(self.atom_type.shape[0])

    @property
    def num_ref(self) -> int:
        if self.pos_ref is None:
            return 0
        return int(self.pos_ref.shape[0] // max(self.num_nodes, 1))

    def bond_adjacency(self) -> np.ndarray:
        """Dense (N, N) int32 typed adjacency of the raw bond graph."""
        n = self.num_nodes
        adj = np.zeros((n, n), dtype=np.int32)
        adj[self.bond_index[0], self.bond_index[1]] = self.bond_type
        return adj

    def undirected_bonds(self) -> Tuple[np.ndarray, np.ndarray]:
        """(E/2, 2) unique undirected bond pairs and their types."""
        i, j = self.bond_index
        keep = i < j
        return np.stack([i[keep], j[keep]], axis=1), self.bond_type[keep]

    def with_pos(self, pos: np.ndarray) -> "Molecule":
        return dataclasses.replace(self, pos=np.asarray(pos, np.float32))

    def heavy_atom_subset(self) -> "Molecule":
        """The molecule without its hydrogens, bonds renumbered (the
        reference's RemoveHs before GetBestRMS, chem.py:133-137)."""
        keep = self.atom_type != 1
        new_index = -np.ones(self.num_nodes, dtype=np.int32)
        new_index[keep] = np.arange(int(keep.sum()), dtype=np.int32)
        i, j = self.bond_index
        bond_keep = keep[i] & keep[j]
        return Molecule(
            atom_type=self.atom_type[keep], pos=self.pos[keep],
            bond_index=np.stack([new_index[i[bond_keep]],
                                 new_index[j[bond_keep]]]),
            bond_type=self.bond_type[bond_keep],
            pos_ref=None if self.pos_ref is None else self.pos_ref.reshape(
                -1, self.num_nodes, 3)[:, keep].reshape(-1, 3),
            smiles=self.smiles, meta=dict(self.meta))

    # --- serialization: one .npz-able dict per molecule ---
    def to_arrays(self) -> Dict[str, np.ndarray]:
        out = {"atom_type": self.atom_type, "pos": self.pos,
               "bond_index": self.bond_index, "bond_type": self.bond_type}
        if self.pos_ref is not None:
            out["pos_ref"] = self.pos_ref
        if self.smiles is not None:
            out["smiles"] = np.array(self.smiles)
        return out

    @classmethod
    def from_arrays(cls, arrs: Dict[str, np.ndarray]) -> "Molecule":
        return cls(atom_type=arrs["atom_type"], pos=arrs["pos"],
                   bond_index=arrs["bond_index"], bond_type=arrs["bond_type"],
                   pos_ref=arrs.get("pos_ref"),
                   smiles=str(arrs["smiles"]) if "smiles" in arrs else None)


def save_molecules(path: str, mols: List[Molecule]) -> None:
    """A molecule list as one .npz archive: `m<k>/<field>` arrays, the
    molecule's plain meta entries as `m<k>/__meta__`, and `__num__`."""
    payload: Dict[str, np.ndarray] = {"__num__": np.array(len(mols))}
    for k, mol in enumerate(mols):
        for name, arr in mol.to_arrays().items():
            payload[f"m{k}/{name}"] = arr
        # private (underscore) meta entries are runtime caches, not data
        meta = {mk: mv for mk, mv in mol.meta.items()
                if not mk.startswith("_")
                and isinstance(mv, (int, float, str, bool, list, tuple))}
        payload[f"m{k}/__meta__"] = np.array(repr(meta))
    np.savez_compressed(path, **payload)


def load_molecules(path: str) -> List[Molecule]:
    with np.load(path, allow_pickle=False) as data:
        mols = []
        for k in range(int(data["__num__"])):
            prefix = f"m{k}/"
            mol = Molecule.from_arrays({
                name[len(prefix):]: data[name] for name in data.files
                if name.startswith(prefix) and not name.endswith("__meta__")})
            if prefix + "__meta__" in data.files:
                mol.meta = ast.literal_eval(str(data[prefix + "__meta__"]))
            mols.append(mol)
    return mols


def subgraph_bonds(mol: Molecule, keep: np.ndarray):
    """(bond_index, bond_type) of the bonds between kept atoms (a (N,)
    bool), renumbered to the kept atoms' order."""
    new_index = -np.ones(mol.num_nodes, np.int64)
    new_index[keep] = np.arange(int(keep.sum()))
    i, j = mol.bond_index
    bk = keep[i] & keep[j]
    return np.stack([new_index[i[bk]], new_index[j[bk]]]), mol.bond_type[bk]


def connected_components(mol: Molecule) -> np.ndarray:
    """(N,) component id of each atom, 0-based in first-seen order
    (agdiff_tpu/chem/mol.py:158-180; the networkx-free counterpart of the
    reference's MolClusterData subgraph indexing)."""
    n = mol.num_nodes
    comp = -np.ones(n, np.int64)
    adj = [[] for _ in range(n)]
    for a, b in mol.bond_index.T:
        adj[a].append(b)
    next_id = 0
    for start in range(n):
        if comp[start] >= 0:
            continue
        stack = [start]
        comp[start] = next_id
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if comp[v] < 0:
                    comp[v] = next_id
                    stack.append(v)
        next_id += 1
    return comp


def split_disconnected(mol: Molecule) -> List[Molecule]:
    """One Molecule per connected component of `mol` (a '.' SMILES),
    meta {'component', 'parent_smiles'}."""
    comp = connected_components(mol)
    out = []
    for cid in range(comp.max() + 1):
        keep = comp == cid
        bond_index, bond_type = subgraph_bonds(mol, keep)
        out.append(Molecule(
            atom_type=mol.atom_type[keep], pos=mol.pos[keep],
            bond_index=bond_index, bond_type=bond_type, smiles=None,
            meta={"component": cid, "parent_smiles": mol.smiles}))
    return out
