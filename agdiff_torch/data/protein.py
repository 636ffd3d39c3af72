"""Protein-scale machinery: sidechain subgraph sampling and
subgraph-decomposed scoring (port of agdiff_tpu/data/protein.py).

The reference ships this machinery broken (SURVEY.md 2.6); these are the
JAX package's working versions of the same ideas:

  * sample_sidechain_subgraph: pick a backbone atom, take the atoms within
    a cutoff ball, complete every residue it touches, and renumber them
    into a Molecule of their own (the reference's rule, datasets.py:
    883-921);
  * SidechainConformationDataset: such subgraphs over annotated
    structures (chem/pdb.py parse_pdb);
  * subgraph_position_scores: a score function over overlapping spatial
    subgraphs of a structure too large for one bucket, the per-node
    position scores averaged back onto the structure.

Host numpy; a numpy Generator's seed gives the JAX package's subgraphs
bit for bit. `score_fn` takes the port's GraphBatch (data/bucketing.py
pad_molecules) and may return a torch tensor on any device or an
array.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from agdiff_torch.chem.mol import Molecule, subgraph_bonds
from agdiff_torch.data.bucketing import pad_molecules


def sample_sidechain_subgraph(
        mol: Molecule, annotations: Dict[str, np.ndarray],
        center_idx: Optional[int] = None, cutoff: float = 10.0,
        rng: Optional[np.random.Generator] = None) -> Optional[Molecule]:
    """The residue-complete subgraph within `cutoff` A of a backbone atom
    (`center_idx`, or one drawn from `rng`), meta: parent_index,
    center_idx, is_sidechain, is_backbone, res_id. None when the
    selection is degenerate (fewer than 4 atoms, or no backbone), as the
    reference's None-dropping collate expects."""
    rng = rng or np.random.default_rng()
    is_backbone = annotations["is_backbone"]
    res_id = annotations["res_id"]
    backbone_idx = np.nonzero(is_backbone)[0]
    if backbone_idx.size == 0:
        return None
    if center_idx is None:
        center_idx = int(rng.choice(backbone_idx))
    within = np.linalg.norm(mol.pos - mol.pos[center_idx], axis=-1) <= cutoff
    keep = np.isin(res_id, np.unique(res_id[within]))
    if keep.sum() < 4:
        return None
    bond_index, bond_type = subgraph_bonds(mol, keep)
    parent = np.nonzero(keep)[0]
    return Molecule(
        atom_type=mol.atom_type[keep], pos=mol.pos[keep],
        bond_index=bond_index, bond_type=bond_type, smiles=mol.smiles,
        meta={"parent_index": parent.astype(np.int32),
              "center_idx": int(np.searchsorted(parent, center_idx)),
              "is_sidechain": annotations["is_sidechain"][keep],
              "is_backbone": is_backbone[keep],
              "res_id": res_id[keep]})


class SidechainConformationDataset:
    """One random sidechain subgraph per __getitem__ over (Molecule,
    annotations) structures, from a numpy Generator seeded with `seed`
    (the reference's training-time sampler)."""

    def __init__(self, structures: Sequence, cutoff: float = 10.0,
                 seed: int = 0):
        self.structures = list(structures)
        self.cutoff = cutoff
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.structures)

    def __getitem__(self, idx: int) -> Optional[Molecule]:
        mol, ann = self.structures[idx % len(self.structures)]
        return sample_sidechain_subgraph(mol, ann, cutoff=self.cutoff,
                                         rng=self.rng)

    @staticmethod
    def collate(items: List[Optional[Molecule]]) -> List[Molecule]:
        """The samples that did not fail."""
        return [m for m in items if m is not None]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def subgraph_position_scores(mol: Molecule,
                             annotations: Dict[str, np.ndarray], score_fn,
                             max_nodes: int, cutoff: float = 10.0,
                             edge_order: int = 3) -> np.ndarray:
    """(N, 3) float32 position scores of a structure by decomposition:
    backbone atoms in order seed residue-complete subgraphs (those larger
    than max_nodes, or adding no uncovered atom, skipped) until every
    atom is covered; `score_fn(GraphBatch) -> (1, max_nodes, 3)` scores
    each, padded alone to max_nodes, and overlapping scores are averaged.
    An atom no subgraph covers scores 0."""
    n = mol.num_nodes
    total = np.zeros((n, 3), np.float64)
    counts = np.zeros((n,), np.float64)
    covered = np.zeros((n,), bool)
    rng = np.random.default_rng(0)
    for center in np.nonzero(annotations["is_backbone"])[0]:
        if covered.all():
            break
        sub = sample_sidechain_subgraph(mol, annotations,
                                        center_idx=int(center),
                                        cutoff=cutoff, rng=rng)
        if sub is None or sub.num_nodes > max_nodes:
            continue
        parent = sub.meta["parent_index"]
        if covered[parent].all():
            continue
        batch = pad_molecules([sub], max_nodes, edge_order, batch_size=1)
        total[parent] += _numpy(score_fn(batch))[0, :sub.num_nodes]
        counts[parent] += 1.0
        covered[parent] = True
    return (total / np.maximum(counts, 1.0)[:, None]).astype(np.float32)
