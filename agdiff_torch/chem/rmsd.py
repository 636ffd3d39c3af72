"""Symmetry-aware best RMSD, the COV/MAT metric (port of
agdiff_tpu/chem/rmsd.py:29-181; numpy in float64, host only).

The reference scores with RDKit's GetBestRMS on H-stripped molecules
(reference: src/agdiff/utils/chem.py:133-137): the aligned RMSD minimised
over the graph's automorphisms. Here, without RDKit:

* `kabsch_rmsd`: the optimal superposition (proper rotations: SVD with
  the determinant's sign);
* `graph_automorphisms`: Weisfeiler-Leman colour refinement (vertex
  colour the atomic number, edge colour the bond type), then
  backtracking over colour-compatible candidates;
* `best_rmsd`: the minimum over automorphisms.

`rmsd_confusion_matrix` has two paths, and `last_path` says which one its
last call ran. use_native=True (the default) runs native/rmsd.cpp through
chem/native_rmsd.py and raises if that library cannot be built or loaded;
unlike the JAX package (rmsd.py:154-161) it never falls back. use_native
=False runs the numpy code below. The two agree to float64 rounding
(quaternion against SVD superposition); the evaluator names its path.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from agdiff_torch.chem.mol import Molecule

# "native" or "numpy": the path of the last rmsd_confusion_matrix call
last_path: Optional[str] = None


def kabsch_rmsd(ref: np.ndarray, gen: np.ndarray) -> float:
    """The least RMSD of two conformations over rotations and
    translations (no reflection)."""
    p = np.asarray(ref, np.float64)
    q = np.asarray(gen, np.float64)
    p = p - p.mean(axis=0)
    q = q - q.mean(axis=0)
    u, s, vt = np.linalg.svd(q.T @ p)
    d = np.sign(np.linalg.det(u @ vt))
    # E = sum |p|^2 + sum |q|^2 - 2 trace(S diag(1, 1, d))
    e0 = (p * p).sum() + (q * q).sum()
    msd = max(e0 - 2.0 * (s[0] + s[1] + d * s[2]), 0.0) / p.shape[0]
    return float(np.sqrt(msd))


def _refine_colors(atom_labels: np.ndarray, adj_type: np.ndarray,
                   iters: int = 10) -> np.ndarray:
    """Weisfeiler-Leman colour refinement: stable vertex colours."""
    n = len(atom_labels)
    colors = np.unique(atom_labels, return_inverse=True)[1]
    for _ in range(iters):
        sigs = []
        for i in range(n):
            nbr = sorted((int(adj_type[i, j]), int(colors[j]))
                         for j in range(n) if adj_type[i, j] > 0)
            sigs.append((int(colors[i]), tuple(nbr)))
        table = {s: k for k, s in enumerate(sorted(set(sigs)))}
        new = np.array([table[s] for s in sigs])
        if (new == colors).all():
            break
        colors = new
    return colors


def graph_automorphisms(atom_labels: np.ndarray, adj_type: np.ndarray,
                        max_maps: int = 10000) -> Iterator[np.ndarray]:
    """The automorphisms of a vertex- and edge-labelled graph, as
    permutations p with p[i] the image of vertex i, at most max_maps."""
    n = len(atom_labels)
    colors = _refine_colors(atom_labels, adj_type)
    # the vertices with the fewest candidates first: early pruning
    order = sorted(range(n), key=lambda i: (colors == colors[i]).sum())
    mapping = -np.ones(n, np.int64)
    used = np.zeros(n, bool)
    count = 0

    def backtrack(depth: int):
        nonlocal count
        if count >= max_maps:
            return
        if depth == n:
            count += 1
            yield mapping.copy()
            return
        v = order[depth]
        for w in range(n):
            if used[w] or colors[w] != colors[v]:
                continue
            # the edges to the vertices mapped so far must match
            if any(adj_type[v, u] != adj_type[w, mapping[u]]
                   for u in order[:depth]):
                continue
            mapping[v] = w
            used[w] = True
            yield from backtrack(depth + 1)
            used[w] = False
            mapping[v] = -1

    yield from backtrack(0)


def scored_graph(mol: Molecule, strip_hydrogens: bool):
    """(kept atoms, vertex labels, typed adjacency) of the graph scored:
    the heavy atoms (the reference's RemoveHs) or all of them."""
    if strip_hydrogens:
        heavy = mol.heavy_atom_subset()
        return mol.atom_type != 1, heavy.atom_type, heavy.bond_adjacency()
    return (np.ones(mol.num_nodes, bool), mol.atom_type,
            mol.bond_adjacency())


def best_rmsd(mol: Molecule, pos_ref: np.ndarray, pos_gen: np.ndarray,
              strip_hydrogens: bool = True, max_maps: int = 10000) -> float:
    """The symmetry-aware least RMSD of a generated conformation of `mol`
    against a reference one (the reference's get_best_rmsd: RemoveHs,
    then GetBestRMS)."""
    keep, labels, adj = scored_graph(mol, strip_hydrogens)
    pos_ref = np.asarray(pos_ref, np.float64).reshape(-1, 3)[keep]
    pos_gen = np.asarray(pos_gen, np.float64).reshape(-1, 3)[keep]
    return float(min((kabsch_rmsd(pos_ref, pos_gen[perm])
                      for perm in graph_automorphisms(labels, adj,
                                                      max_maps=max_maps)),
                     default=np.inf))


def rmsd_confusion_matrix(mol: Molecule, pos_refs: np.ndarray,
                          pos_gens: np.ndarray, strip_hydrogens: bool = True,
                          max_maps: int = 10000,
                          use_native: bool = True) -> np.ndarray:
    """(num_ref, num_gen) best-RMSD matrix (reference: covmat.py:16-34),
    natively or in numpy (module docstring); raises if use_native and
    the native library cannot be built or loaded."""
    global last_path
    if use_native:
        from agdiff_torch.chem import native_rmsd

        out = native_rmsd.rmsd_confusion_matrix(
            mol, pos_refs, pos_gens, strip_hydrogens=strip_hydrogens,
            max_maps=max_maps)
        last_path = "native"
        return out
    keep, labels, adj = scored_graph(mol, strip_hydrogens)
    # the automorphisms once, for every pair
    perms = list(graph_automorphisms(labels, adj, max_maps=max_maps))
    refs = np.asarray(pos_refs, np.float64)[:, keep]
    gens = np.asarray(pos_gens, np.float64)[:, keep]
    out = -np.ones((len(refs), len(gens)))
    for j in range(len(gens)):
        permuted = [gens[j][p] for p in perms]
        for i in range(len(refs)):
            out[i, j] = min(kabsch_rmsd(refs[i], g) for g in permuted)
    last_path = "numpy"
    return out
