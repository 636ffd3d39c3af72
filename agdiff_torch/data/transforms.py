"""Host-side graph transforms, numpy (port of
agdiff_tpu/data/transforms.py).

The one on the training and sampling paths is the bond-order extension:
order_mat[i, j] = k where k is the shortest hop count (1..order) between i
and j in the bond graph (0 if farther or i == j). 1-hop entries keep their
chemical bond type; k-hop entries (k >= 2) get type NUM_BOND_TYPES + k - 1.
The others are the reference's auxiliary transforms (its utils/
transforms.py:74-186), off those paths; each stores its result in the
molecule's meta.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from agdiff_torch.chem.constants import (
    ATOM_SYMBOLS,
    BOND_NAMES,
    NUM_BOND_TYPES,
)


def extend_bond_order(bond_adj: np.ndarray, order: int = 3,
                      num_types: int = NUM_BOND_TYPES) -> np.ndarray:
    """(N, N) typed adjacency -> (N, N) int32 with k-hop edges added."""
    adj = (bond_adj > 0).astype(np.int64)
    n = adj.shape[0]
    eye = np.eye(n, dtype=np.int64)
    one_hop = ((adj + eye) > 0).astype(np.int64)
    reach = one_hop
    hop = reach - eye
    for k in range(2, order + 1):
        reach_next = ((reach @ one_hop) > 0).astype(np.int64)
        hop += (reach_next - reach) * k
        reach = reach_next
    high = np.where(hop > 1, num_types + hop - 1, 0)
    return np.where(hop == 1, bond_adj, high).astype(np.int32)


def edges_from_adjacency(adj: np.ndarray):
    """A dense typed adjacency -> (edge_index (2, E), edge_type (E,)),
    int32, in row-major order (the reference's dense_to_sparse and
    coalesce)."""
    i, j = np.nonzero(adj)
    return np.stack([i, j]).astype(np.int32), adj[i, j].astype(np.int32)


def center_positions(pos: np.ndarray) -> np.ndarray:
    """Positions with their mean subtracted."""
    return pos - pos.mean(axis=0, keepdims=True)


def add_edge_length(mol) -> None:
    """meta['edge_length']: each directed bond's length (AddEdgeLength)."""
    i, j = mol.bond_index
    mol.meta["edge_length"] = np.linalg.norm(
        mol.pos[i] - mol.pos[j], axis=-1).astype(np.float32)


def add_placeholder(mol) -> None:
    """meta pos_gen, d_gen and d_recover filled with -1 (AddPlaceHolder)."""
    mol.meta["pos_gen"] = -np.ones_like(mol.pos)
    e = mol.bond_index.shape[1]
    mol.meta["d_gen"] = -np.ones((e, 1), np.float32)
    mol.meta["d_recover"] = -np.ones((e, 1), np.float32)


def add_edge_name(mol, asymmetric: bool = True) -> None:
    """meta['edge_name']: '<type>_<tail>_<head>_<i>_<j>_<length>' per
    directed bond ('' for tail >= head when asymmetric) (AddEdgeName)."""
    names = dict(BOND_NAMES)
    names[len(BOND_NAMES) + 1] = "Angle"
    names[len(BOND_NAMES) + 2] = "Dihedral"
    if "edge_length" not in mol.meta:
        add_edge_length(mol)
    out = []
    for k in range(mol.bond_index.shape[1]):
        tail, head = int(mol.bond_index[0, k]), int(mol.bond_index[1, k])
        if asymmetric and tail >= head:
            out.append("")
            continue
        t = int(mol.bond_type[k])
        tail_sym = ATOM_SYMBOLS.get(int(mol.atom_type[tail]), "X")
        head_sym = ATOM_SYMBOLS.get(int(mol.atom_type[head]), "X")
        out.append(f"{names.get(t, f'E{t}')}_{tail_sym}_{head_sym}_{tail}_"
                   f"{head}_{mol.meta['edge_length'][k]:.3f}")
    mol.meta["edge_name"] = out


def add_angle_dihedral(mol) -> None:
    """meta['angle_index'] (3, A): bonded (j, k, l), j < l, and
    meta['dihedral_index'] (4, D): (k, i, j, l) around each bond i < j
    (AddAngleDihedral's iteration order)."""
    adj = mol.bond_adjacency() > 0
    n = adj.shape[0]
    angles = [(j, k, l) for j in range(n) for k in range(n)
              for l in range(n)
              if adj[j, k] and adj[k, l] and j != k and k != l and j < l]
    dihedrals = []
    for i in range(n):
        for j in range(i + 1, n):
            if not adj[i, j]:
                continue
            for k in range(n):
                for l in range(n):
                    if k in (i, j) or l in (i, j):
                        continue
                    if adj[k, i] and adj[l, j]:
                        dihedrals.append((k, i, j, l))
    mol.meta["angle_index"] = (np.array(angles, np.int32).T if angles
                               else np.zeros((3, 0), np.int32))
    mol.meta["dihedral_index"] = (np.array(dihedrals, np.int32).T
                                  if dihedrals else np.zeros((4, 0),
                                                             np.int32))


def symmetric_edge_noise(
        generator: Union[np.random.Generator, torch.Generator],
        bond_index: np.ndarray) -> np.ndarray:
    """(E, 1) float32 Gaussian noise, one draw per undirected bond put on
    both its directed copies (the reference's
    generate_symmetric_edge_noise, common.py:112-132), drawn from a numpy
    or a CPU torch generator."""
    i, j = bond_index
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    key = hi.astype(np.int64) * (hi + 1) + lo
    uniq, inverse = np.unique(key, return_inverse=True)
    if isinstance(generator, torch.Generator):
        noise = torch.randn(len(uniq), generator=generator).numpy()
    else:
        noise = generator.normal(size=len(uniq)).astype(np.float32)
    return noise[inverse.reshape(-1)][:, None]
