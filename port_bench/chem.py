"""Synthetic molecules for the benchmark's test sets: tree chemistry in
numpy (a random spanning tree over C, N, O and F, single bonds, hydrogens
filled to valence, 3D positions from random bond directions and a steric
relaxation). The benchmark's own copy, so that later edits to the
program's generator do not move the yardstick.

`tree_molecule(rng, heavy)` draws a molecule with that many heavy
atoms. A molecule is a dict of numpy
arrays: `atom_type` (N,), `pos` (N, 3) float32, `bonds` (E, 2) undirected
pairs i < j (every bond SINGLE, type 1).
"""

from __future__ import annotations

import numpy as np

HEAVY = np.array([6, 6, 6, 6, 7, 8, 9])        # C-rich, like QM9
VALENCE = {1: 1, 6: 4, 7: 3, 8: 2, 9: 1}
BOND_LEN = {1: 1.09, 6: 1.52, 7: 1.45, 8: 1.41, 9: 1.38}
SINGLE = 1


def _tree(rng: np.random.Generator, heavy: int):
    """Heavy atom types, each atom's parent, and the hydrogen count."""
    types = rng.choice(HEAVY, size=heavy).astype(np.int32)
    types[0] = 6
    parent = np.zeros(heavy, np.int64)
    for i in range(1, heavy):
        parent[i] = rng.integers(0, i)
    degree = np.bincount(parent[1:], minlength=heavy) + (
        np.arange(heavy) > 0)
    hydrogens = [max(0, VALENCE[int(t)] - int(d))
                 for t, d in zip(types, degree)]
    return types, parent, hydrogens


def _geometry(rng, types, parent, hydrogens) -> dict:
    heavy = len(types)
    pos = np.zeros((heavy, 3))
    for i in range(1, heavy):
        d = rng.normal(size=3)
        p = parent[i]
        pos[i] = pos[p] + d / np.linalg.norm(d) * 0.5 * (
            BOND_LEN[int(types[p])] + BOND_LEN[int(types[i])])
    for _ in range(30):   # push non-bonded heavy atoms apart, keep bonds
        diff = pos[:, None] - pos[None, :]
        dist = np.linalg.norm(diff, axis=-1) + np.eye(heavy)
        pos += 0.05 * np.where(dist[..., None] < 1.8,
                               diff / dist[..., None] ** 3, 0.0).sum(1)
        for i in range(1, heavy):
            p = parent[i]
            v = pos[i] - pos[p]
            pos[i] = pos[p] + v / (np.linalg.norm(v) + 1e-9) * 0.5 * (
                BOND_LEN[int(types[p])] + BOND_LEN[int(types[i])])
    atom_type = list(types)
    allpos = list(pos)
    bonds = [(int(parent[i]), i) for i in range(1, heavy)]
    for i, count in enumerate(hydrogens):
        for _ in range(count):
            d = rng.normal(size=3)
            bonds.append((i, len(atom_type)))
            allpos.append(pos[i] + d / np.linalg.norm(d) * BOND_LEN[1])
            atom_type.append(1)
    out = np.asarray(allpos, np.float32)
    return {"atom_type": np.asarray(atom_type, np.int32),
            "pos": out - out.mean(0, keepdims=True),
            "bonds": np.asarray(bonds, np.int64).reshape(-1, 2)}


def tree_molecule(rng: np.random.Generator, heavy: int) -> dict:
    """A tree molecule of `heavy` heavy atoms (hydrogens filled)."""
    return _geometry(rng, *_tree(rng, int(heavy)))


def adjacency(mol: dict) -> np.ndarray:
    """(N, N) typed adjacency of the raw bond graph."""
    n = len(mol["atom_type"])
    adj = np.zeros((n, n), np.int64)
    i, j = mol["bonds"].T
    adj[i, j] = adj[j, i] = SINGLE
    return adj
