"""Bucketed padding: molecules -> GraphBatch (port of
agdiff_tpu/data/bucketing.py).

A molecule goes to the smallest bucket N >= its atom count; node arrays
are padded to N and B molecules of one bucket are collated densely.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from agdiff_torch.chem.mol import Molecule
from agdiff_torch.data.graph_batch import GraphBatch
from agdiff_torch.data.transforms import extend_bond_order


def pick_bucket(num_nodes: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits, else raise."""
    for b in sorted(buckets):
        if num_nodes <= b:
            return b
    raise ValueError(f"Molecule with {num_nodes} atoms exceeds largest "
                     f"bucket {max(buckets)}")


def _extended_adjacency(mol: Molecule, edge_order: int) -> np.ndarray:
    """Order-extended adjacency, memoized on the molecule (it does not
    depend on positions)."""
    key = f"_ext_adj_{edge_order}"
    cached = mol.meta.get(key)
    if cached is None:
        raw = mol.bond_adjacency()
        cached = (extend_bond_order(raw, order=edge_order) if edge_order
                  else raw)
        mol.meta[key] = cached
    return cached


def pad_molecules(mols: List[Molecule], max_nodes: int, edge_order: int = 3,
                  batch_size: Optional[int] = None,
                  device="cpu") -> GraphBatch:
    """Collate molecules (all fitting in `max_nodes`) into one GraphBatch.
    With batch_size > len(mols) the batch is padded with empty graphs."""
    b = batch_size or len(mols)
    atom_type = np.zeros((b, max_nodes), np.int64)
    pos = np.zeros((b, max_nodes, 3), np.float32)
    node_mask = np.zeros((b, max_nodes), bool)
    bond_adj = np.zeros((b, max_nodes, max_nodes), np.int64)
    graph_mask = np.zeros((b,), bool)
    for k, mol in enumerate(mols):
        n = mol.num_nodes
        if n > max_nodes:
            raise ValueError(f"molecule has {n} > {max_nodes} atoms")
        atom_type[k, :n] = mol.atom_type
        pos[k, :n] = mol.pos
        node_mask[k, :n] = True
        bond_adj[k, :n, :n] = _extended_adjacency(mol, edge_order)
        graph_mask[k] = True
    return GraphBatch(
        atom_type=torch.from_numpy(atom_type),
        pos=torch.from_numpy(pos),
        node_mask=torch.from_numpy(node_mask),
        bond_adj=torch.from_numpy(bond_adj),
        graph_mask=torch.from_numpy(graph_mask),
    ).to(device)


def repeat_molecule(mol: Molecule, num_repeats: int, max_nodes: int,
                    edge_order: int = 3, device="cpu") -> GraphBatch:
    """One molecule replicated num_repeats times (the generation pattern)."""
    return pad_molecules([mol] * num_repeats, max_nodes, edge_order,
                         device=device)


def group_by_bucket(mols: List[Molecule],
                    buckets: Sequence[int]) -> Dict[int, List[int]]:
    """Molecule indices grouped by their bucket size, in index order."""
    groups: Dict[int, List[int]] = {}
    for idx, m in enumerate(mols):
        groups.setdefault(pick_bucket(m.num_nodes, buckets), []).append(idx)
    return groups
