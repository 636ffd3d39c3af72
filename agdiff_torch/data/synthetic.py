"""Synthetic molecule generation (RDKit-free) for tests and benchmarks
(the port's copy of agdiff_tpu/data/synthetic.py: the same molecules
for the same arguments, the rich chemistry's geometry relaxation through
the same native kernel, data/native_relax.py).

Two generators, selected by ``synthetic_dataset(chem=...)``:

* ``chem='tree'`` (default, byte-stable across rounds for a given seed):
  a random spanning tree over heavy atoms, SINGLE bonds only, hydrogens
  filled to typical valence, 3D coordinates from a crude embedding.
* ``chem='rich'``: rings (3-6 membered, optionally aromatic) plus the
  reference's live bond-type vocabulary — SINGLE/DOUBLE/TRIPLE/AROMATIC with
  exact valence accounting, type-dependent bond lengths, and a wider
  heteroatom palette (C/N/O/F/S/Cl). This matches the structural diversity
  of GEOM molecules as emitted by the reference's rdmol_to_data
  (src/agdiff/utils/datasets.py:348-360; bond vocab chem.py:17-18), so
  bond-embedding rows beyond SINGLE and the GIN's edge-type handling are
  actually trained.

These are NOT meant to be valid chemistry — they exercise the exact tensor
shapes, edge-type vocabulary, and statistics of GEOM-like data so the full
train/sample/eval stack runs without RDKit or the GEOM download (reference
data pipeline: src/agdiff/utils/datasets.py:559-710).
"""

from __future__ import annotations

from typing import List

import numpy as np

from agdiff_torch.chem.constants import BondType
from agdiff_torch.chem.mol import Molecule

_HEAVY = np.array([6, 6, 6, 6, 7, 8, 9])  # C-rich, like QM9
_VALENCE = {1: 1, 6: 4, 7: 3, 8: 2, 9: 1, 15: 3, 16: 2, 17: 1, 35: 1}
_BOND_LEN = {1: 1.09, 6: 1.52, 7: 1.45, 8: 1.41, 9: 1.38,
             15: 2.16, 16: 2.12, 17: 2.02, 35: 2.28}

# --- rich-chemistry vocabulary (chem='rich') ---
_RICH_HEAVY = np.array([6, 6, 6, 6, 6, 7, 7, 8, 8, 9, 16, 17])  # + S, Cl
_AROMATIC_RING = np.array([6, 6, 6, 6, 6, 7])   # benzene/pyridine-like
_PLAIN_RING = np.array([6, 6, 6, 6, 7, 8, 16])  # saturated heterocycles
# valence consumed per bond, keyed by BondType id
_ORDER = {int(BondType.SINGLE): 1.0, int(BondType.DOUBLE): 2.0,
          int(BondType.TRIPLE): 3.0, int(BondType.AROMATIC): 1.5}
# bond-length contraction vs the single-bond length
_LEN_FACTOR = {int(BondType.SINGLE): 1.0, int(BondType.DOUBLE): 0.875,
               int(BondType.TRIPLE): 0.79, int(BondType.AROMATIC): 0.915}


def _pair_length(zi: int, zj: int, btype: int) -> float:
    """Equilibrium bond length for an element pair and bond type."""
    if 1 in (zi, zj):
        return 1.09
    return 0.5 * (_BOND_LEN[zi] + _BOND_LEN[zj]) * _LEN_FACTOR[btype]


def heavy_range(max_heavy: int, spread: int = 4) -> tuple:
    """Clamped (min_heavy, max_heavy) from a user-facing size knob.

    Without clamping, ``max(4, h - spread)`` exceeds ``h`` for h < 4 and
    ``rng.integers(low, high)`` raises. Result satisfies 4 <= min <= max.
    """
    hi = max(int(max_heavy), 4)
    lo = min(max(4, hi - spread), hi)
    return lo, hi


_TET_COS = 1.0 / 3.0                     # cos(70.53 deg): tetrahedral
_TET_SIN = np.sqrt(8.0) / 3.0
_TET_DIRS = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                     np.float64) / np.sqrt(3.0)  # root: 4 true vertices


def _frame(u, ref):
    """Deterministic orthonormal (v, w) perpendicular to u, seeded by ref."""
    v = ref - u * float(np.dot(ref, u))
    n = np.linalg.norm(v)
    if n < 1e-6:
        ref = np.array([0.0, 0.0, 1.0]) if abs(u[2]) < 0.9 else \
            np.array([1.0, 0.0, 0.0])
        v = ref - u * float(np.dot(ref, u))
        n = np.linalg.norm(v)
    v = v / n
    return v, np.cross(u, v)


def _rigid_place(pos_p, u, v, w, k, length):
    """k-th tetrahedral substituent direction off the bond axis u."""
    phi = k * (2.0 * np.pi / 3.0)
    d = u * _TET_COS + (v * np.cos(phi) + w * np.sin(phi)) * _TET_SIN
    return pos_p + d * length


def random_molecule(
    rng: np.random.Generator,
    num_heavy: int = 9,
    add_hydrogens: bool = True,
    num_conformers: int = 0,
    jitter: float = 0.15,
    rigid: bool = False,
    multiref: bool = False,
) -> Molecule:
    """A random tree-structured molecule with approximate 3D geometry.

    rigid=False (default): bond DIRECTIONS are random — the 3D shape is
    underdetermined by the molecular graph (like free torsions), which puts
    an irreducible floor under MAT-R for models that only see the graph.
    rigid=True: a deterministic tetrahedral z-matrix embedding — geometry
    is a consistent function of local structure (sp3 angles, substituent
    slots ordered by construction), so conformation is fully learnable."""
    heavy = rng.choice(_HEAVY, size=num_heavy).astype(np.int32)
    heavy[0] = 6
    pairs = []  # undirected (i, j, type)
    # random spanning tree over heavy atoms
    pos = np.zeros((num_heavy, 3), np.float64)
    parent = np.zeros(num_heavy, np.int64)
    children: dict = {i: [] for i in range(num_heavy)}
    if rigid:
        for i in range(1, num_heavy):
            p = int(rng.integers(0, i))
            parent[i] = p
            children[p].append(i)
            pairs.append((p, i, int(BondType.SINGLE)))
        # deterministic tetrahedral placement, children in index order
        axis = {0: np.array([0.0, 0.0, 1.0])}  # root pseudo-bond axis
        order = sorted(range(1, num_heavy))
        slot = {i: 0 for i in range(num_heavy)}
        for i in order:  # generation order == BFS-compatible (parent < i)
            p = int(parent[i])
            length = 0.5 * (_BOND_LEN[int(heavy[p])]
                            + _BOND_LEN[int(heavy[i])])
            if p == 0:
                # root has no incoming bond: its (up to 4) substituents sit
                # on the true tetrahedral vertices
                pos[i] = pos[p] + _TET_DIRS[slot[p] % 4] * length
            else:
                u = axis[p]
                ref = axis.get(int(parent[p]), np.array([1.0, 0.0, 0.0]))
                v, w = _frame(u, ref)
                pos[i] = _rigid_place(pos[p], u, v, w, slot[p], length)
            slot[p] += 1
            d = pos[i] - pos[p]
            axis[i] = d / np.linalg.norm(d)
        # rigid tree embeddings can self-intersect (no excluded volume);
        # the steric relaxation is a DETERMINISTIC function of the
        # embedding, so geometry remains a function of the graph
        for _ in range(60):
            diff = pos[:, None] - pos[None, :]
            dist = np.linalg.norm(diff, axis=-1) + np.eye(num_heavy)
            force = np.where(dist[..., None] < 1.8,
                             diff / np.maximum(dist[..., None], 0.3) ** 3,
                             0.0)
            pos += 0.05 * force.sum(axis=1)
            for i in range(1, num_heavy):  # restore bond lengths
                p = int(parent[i])
                v = pos[i] - pos[p]
                length = 0.5 * (_BOND_LEN[int(heavy[p])]
                                + _BOND_LEN[int(heavy[i])])
                pos[i] = pos[p] + v / (np.linalg.norm(v) + 1e-9) * length
        # refresh bond axes for the H placement below
        for i in range(1, num_heavy):
            d = pos[i] - pos[int(parent[i])]
            axis[i] = d / np.linalg.norm(d)
    else:
        # NOTE: parent and direction draws stay INTERLEAVED — the original
        # rng call order — so rigid=False reproduces the exact molecules of
        # earlier rounds for a given seed
        for i in range(1, num_heavy):
            p = int(rng.integers(0, i))
            parent[i] = p
            children[p].append(i)
            pairs.append((p, i, int(BondType.SINGLE)))
            direction = rng.normal(size=3)
            direction /= np.linalg.norm(direction)
            length = 0.5 * (_BOND_LEN[int(heavy[p])]
                            + _BOND_LEN[int(heavy[i])])
            pos[i] = pos[p] + direction * length
        # simple steric relaxation: push non-bonded heavy atoms apart
        for _ in range(30):
            diff = pos[:, None] - pos[None, :]
            dist = np.linalg.norm(diff, axis=-1) + np.eye(num_heavy)
            force = np.where(dist[..., None] < 1.8,
                             diff / dist[..., None] ** 3, 0.0)
            pos += 0.05 * force.sum(axis=1)
            for i in range(1, num_heavy):  # restore bond lengths
                p = parent[i]
                v = pos[i] - pos[p]
                length = 0.5 * (_BOND_LEN[int(heavy[p])]
                                + _BOND_LEN[int(heavy[i])])
                pos[i] = pos[p] + v / (np.linalg.norm(v) + 1e-9) * length

    atom_type = list(heavy)
    positions = list(pos)
    degree = np.zeros(num_heavy, np.int64)
    for i, j, _ in pairs:
        degree[i] += 1
        degree[j] += 1
    if add_hydrogens:
        for i in range(num_heavy):
            free = max(0, _VALENCE[int(heavy[i])] - int(degree[i]))
            if rigid and free:
                # fill remaining tetrahedral slots deterministically
                base = len(children[i])
                if i == 0:
                    for k in range(free):
                        h_idx = len(atom_type)
                        atom_type.append(1)
                        positions.append(
                            pos[0] + _TET_DIRS[(base + k) % 4] * 1.09)
                        pairs.append((0, h_idx, int(BondType.SINGLE)))
                    continue
                d = pos[i] - pos[int(parent[i])]
                u = d / np.linalg.norm(d)
                gp = int(parent[int(parent[i])])
                ref_vec = pos[int(parent[i])] - pos[gp]
                nrm = np.linalg.norm(ref_vec)
                ref = ref_vec / nrm if nrm > 1e-6 else \
                    np.array([1.0, 0.0, 0.0])
                v, w = _frame(u, ref)
                for k in range(free):
                    h_idx = len(atom_type)
                    atom_type.append(1)
                    positions.append(
                        _rigid_place(pos[i], u, v, w, base + k, 1.09))
                    pairs.append((i, h_idx, int(BondType.SINGLE)))
            else:
                for _ in range(free):
                    h_idx = len(atom_type)
                    atom_type.append(1)
                    d = rng.normal(size=3)
                    d /= np.linalg.norm(d)
                    positions.append(pos[i] + d * 1.09)
                    pairs.append((i, h_idx, int(BondType.SINGLE)))

    n = len(atom_type)
    if rigid:
        # final deterministic all-atom de-clash (H arms can collide across
        # branches); every tree bond lists the child second, so bond
        # restoration walks child-ward
        allpos = np.asarray(positions, np.float64)
        lengths = [
            0.5 * (_BOND_LEN[int(atom_type[i])] + _BOND_LEN[int(atom_type[j])])
            if 1 not in (int(atom_type[i]), int(atom_type[j])) else 1.09
            for i, j, _ in pairs
        ]
        for _ in range(40):
            diff = allpos[:, None] - allpos[None, :]
            dist = np.linalg.norm(diff, axis=-1) + np.eye(n)
            force = np.where(dist[..., None] < 1.5,
                             diff / np.maximum(dist[..., None], 0.3) ** 3,
                             0.0)
            allpos += 0.03 * force.sum(axis=1)
            for (i, j, _), length in zip(pairs, lengths):
                v = allpos[j] - allpos[i]
                allpos[j] = allpos[i] + v / (np.linalg.norm(v) + 1e-9) * length
        positions = list(allpos)
    src, dst, types = [], [], []
    for i, j, t in pairs:
        src += [i, j]
        dst += [j, i]
        types += [t, t]
    # row-major sort to match reference edge ordering (datasets.py:356-360)
    order = np.lexsort((np.array(dst), np.array(src)))
    primary = np.asarray(positions, np.float32)
    primary = primary - primary.mean(0, keepdims=True)
    mol = Molecule(
        atom_type=np.array(atom_type, np.int32),
        pos=primary,
        bond_index=np.stack([np.array(src)[order], np.array(dst)[order]]),
        bond_type=np.array(types, np.int32)[order],
        smiles=f"SYN-{num_heavy}-{int(rng.integers(1 << 30))}",
    )
    if num_conformers > 0:
        if multiref:  # distinct torsional modes, GEOM-like
            refs = [torsion_conformer(mol, rng, jitter=jitter)
                    for _ in range(num_conformers)]
        else:  # thermal jitters of the primary (byte-stable legacy mode)
            refs = [
                primary + rng.normal(scale=jitter,
                                     size=(n, 3)).astype(np.float32)
                for _ in range(num_conformers)
            ]
        mol.pos_ref = np.concatenate(refs, axis=0)
    return mol


def _relax(pos, constraints, exclude, iters, step=0.04, repulse=1.5,
           polish=None, use_native=True):
    """SHAKE-style geometry relaxation: soft repulsion between non-bonded
    close atoms plus symmetric projection of every distance constraint
    (both endpoints move), which preserves ring closure — the tree
    generators' parent-only restoration cannot. `polish` (default: all
    constraints) is the subset projected in the final repulsion-free sweeps
    — pass the bond list so exact bond lengths win over the (approximate)
    ring-shape chords.

    By default the native kernel runs it (data/native_relax.py:
    native/relax.cpp, the same f64 math, ~1e-6 from this body), and
    raises where it cannot be built; use_native=False runs this numpy
    body, the parity reference (agdiff_tpu/data/synthetic.py:286-305,
    which falls back to it instead)."""
    if use_native:
        from agdiff_torch.data import native_relax

        return native_relax.relax(pos, constraints, exclude, iters, step,
                                  repulse, polish)
    n = pos.shape[0]
    eye = np.eye(n, dtype=bool)
    for _ in range(iters):
        diff = pos[:, None] - pos[None, :]
        dist = np.linalg.norm(diff, axis=-1) + eye
        close = (dist < repulse) & ~exclude & ~eye
        force = np.where(close[..., None],
                         diff / np.maximum(dist[..., None], 0.3) ** 3, 0.0)
        pos = pos + step * force.sum(axis=1)
        for _ in range(4):  # Gauss-Seidel projection sweeps (sequential:
            for i, j, d in constraints:  # simultaneous updates overshoot
                v = pos[j] - pos[i]      # on shared atoms and diverge)
                ln = float(np.linalg.norm(v)) + 1e-9
                corr = 0.5 * (ln - d) / ln * v
                pos[i] = pos[i] + corr
                pos[j] = pos[j] - corr
    for _ in range(25):  # projection-only polish: repulsion doesn't get
        for i, j, d in (polish or constraints):  # the last word on bonds
            v = pos[j] - pos[i]
            ln = float(np.linalg.norm(v)) + 1e-9
            corr = 0.5 * (ln - d) / ln * v
            pos[i] = pos[i] + corr
            pos[j] = pos[j] - corr
    return pos


def random_rich_molecule(
    rng: np.random.Generator,
    num_heavy: int = 9,
    add_hydrogens: bool = True,
    num_conformers: int = 0,
    jitter: float = 0.15,
    multiref: bool = False,
) -> Molecule:
    """A random molecule with rings and the full live bond-type vocabulary.

    Construction: (1) plan 0-2 rings (sizes 3-6; 6-rings may be aromatic)
    and assemble them as cycles with exact valence accounting; (2) attach
    remaining heavy atoms (and the extra rings) by single bonds, always
    keeping enough free valence to finish; (3) stochastically upgrade
    eligible acyclic/plain-ring single bonds to DOUBLE (and acyclic to
    TRIPLE) where both endpoints have the valence to spare and neither is
    already multiply bonded; (4) embed rings as regular polygons and relax
    all atoms under per-bond-type length constraints plus ring-chord
    constraints (which hold ring shape through the relaxation); (5) fill
    hydrogens to exact valence and relax once more.
    """
    num_heavy = max(int(num_heavy), 3)

    # --- (1) ring plan ---
    sizes, aromatic = [], []
    remaining = num_heavy
    max_rings = 2 if num_heavy >= 10 else (1 if num_heavy >= 5 else 0)
    for _ in range(int(rng.integers(0, max_rings + 1)) if max_rings else 0):
        if remaining < 3:
            break
        size = min(int(rng.choice([3, 4, 5, 5, 6, 6, 6])), remaining)
        if size < 3:
            break
        sizes.append(size)
        aromatic.append(bool(size == 6 and rng.random() < 0.6))
        remaining -= size

    atom_type: List[int] = []
    val_used: List[float] = []
    has_multi: List[bool] = []
    bonds: List[tuple] = []  # undirected (i, j, type)

    def new_atom(z: int) -> int:
        atom_type.append(int(z))
        val_used.append(0.0)
        has_multi.append(False)
        return len(atom_type) - 1

    def free(i: int) -> float:
        return _VALENCE[atom_type[i]] - val_used[i]

    ring_members: List[List[int]] = []
    for size, arom in zip(sizes, aromatic):
        pool = _AROMATIC_RING if arom else _PLAIN_RING
        members = [new_atom(6), new_atom(6)]  # >=2 ring carbons guarantee
        members += [new_atom(int(rng.choice(pool))) for _ in range(size - 2)]
        bt = int(BondType.AROMATIC) if arom else int(BondType.SINGLE)
        for t in range(size):
            i, j = members[t], members[(t + 1) % size]
            bonds.append((i, j, bt))
            val_used[i] += _ORDER[bt]
            val_used[j] += _ORDER[bt]
            if arom:
                has_multi[i] = has_multi[j] = True
        ring_members.append(members)

    # --- (2) attach extra rings, then acyclic atoms, by single bonds ---
    if ring_members:
        connected = list(ring_members[0])
    else:
        connected = [new_atom(6)]  # acyclic root, carbon for capacity
        remaining -= 1

    def attach(comp_ports: List[int], new_idx: List[int]):
        hosts = [i for i in connected if free(i) >= 1.0]
        ports = [i for i in comp_ports if free(i) >= 1.0]
        h = hosts[int(rng.integers(0, len(hosts)))]
        p = ports[int(rng.integers(0, len(ports)))]
        bonds.append((h, p, int(BondType.SINGLE)))
        val_used[h] += 1.0
        val_used[p] += 1.0
        connected.extend(new_idx)

    for members in ring_members[1:]:
        attach([m for m in members if free(m) >= 1.0], members)
    for k in range(remaining):
        z = int(rng.choice(_RICH_HEAVY))
        # capacity rule: keep >=1 free valence in the connected component
        # while atoms remain, so the next attach always has a host
        cap_now = sum(free(i) for i in connected)
        if k < remaining - 1 and cap_now - 1.0 + (_VALENCE[z] - 1.0) < 1.0:
            z = 6
        a = new_atom(z)
        attach([a], [a])

    # --- (3) bond-order upgrades (acyclic + plain-ring singles) ---
    in_aromatic = set()
    for members, arom in zip(ring_members, aromatic):
        if arom:
            in_aromatic.update(members)
    order_idx = rng.permutation(len(bonds))
    for bi in order_idx:
        i, j, t = bonds[bi]
        if t != int(BondType.SINGLE) or has_multi[i] or has_multi[j]:
            continue
        if free(i) >= 2.0 and free(j) >= 2.0 and rng.random() < 0.08:
            bonds[bi] = (i, j, int(BondType.TRIPLE))
            val_used[i] += 2.0
            val_used[j] += 2.0
            has_multi[i] = has_multi[j] = True
        elif free(i) >= 1.0 and free(j) >= 1.0 and rng.random() < 0.35:
            bonds[bi] = (i, j, int(BondType.DOUBLE))
            val_used[i] += 1.0
            val_used[j] += 1.0
            has_multi[i] = has_multi[j] = True

    # --- (4) embedding: rings as regular polygons, BFS for the rest ---
    nh = len(atom_type)
    nbrs = {i: [] for i in range(nh)}
    blen = {}
    for i, j, t in bonds:
        nbrs[i].append(j)
        nbrs[j].append(i)
        blen[(i, j)] = blen[(j, i)] = _pair_length(
            atom_type[i], atom_type[j], t)
    ring_of = {m: r for r, members in enumerate(ring_members)
               for m in members}

    pos = np.zeros((nh, 3))
    placed = np.zeros(nh, bool)

    def place_ring(ridx: int, anchor: int):
        members = ring_members[ridx]
        k = len(members)
        length = blen[(members[0], members[1])]
        radius = length / (2.0 * np.sin(np.pi / k))
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        w = rng.normal(size=3)
        w -= u * float(np.dot(w, u))
        w /= np.linalg.norm(w)
        center = pos[anchor] + radius * u
        start = members.index(anchor)
        for t in range(k):
            m = members[(start + t) % k]
            if not placed[m]:
                a = 2.0 * np.pi * t / k
                pos[m] = center + radius * (-np.cos(a) * u + np.sin(a) * w)
                placed[m] = True

    root = ring_members[0][0] if ring_members else 0
    placed[root] = True
    if root in ring_of:
        place_ring(ring_of[root], root)
    queue = [i for i in range(nh) if placed[i]]
    while queue:
        i = queue.pop(0)
        for j in nbrs[i]:
            if placed[j]:
                continue
            d = rng.normal(size=3)
            d /= np.linalg.norm(d)
            pos[j] = pos[i] + d * blen[(i, j)]
            placed[j] = True
            if j in ring_of:
                place_ring(ring_of[j], j)
                queue.extend(m for m in ring_members[ring_of[j]] if m != j)
            queue.append(j)

    # constraints: every bond + ring chords (shape) + aromatic diagonals
    # (planarity); excluded from the repulsion term
    bond_constraints = [(i, j, blen[(i, j)]) for i, j, _ in bonds]
    constraints = list(bond_constraints)
    for members, arom in zip(ring_members, aromatic):
        k = len(members)
        if k < 4:
            continue
        # mean ring bond length: upgraded (double) ring bonds are shorter,
        # the mean keeps the chord constraints near-consistent with them
        length = float(np.mean([
            blen[(members[t], members[(t + 1) % k])] for t in range(k)]))
        radius = length / (2.0 * np.sin(np.pi / k))
        chord2 = 2.0 * radius * np.sin(2.0 * np.pi / k)
        for t in range(k):
            constraints.append(
                (members[t], members[(t + 2) % k], chord2))
        if arom and k == 6:
            for t in range(3):
                constraints.append((members[t], members[t + 3], 2.0 * radius))
    exclude = np.zeros((nh, nh), bool)
    for i, j, _ in constraints:
        exclude[i, j] = exclude[j, i] = True
    pos = _relax(pos, constraints, exclude, iters=60,
                 polish=bond_constraints)

    # --- (5) hydrogens to exact valence, then a final all-atom relax ---
    all_types = list(atom_type)
    all_pos = list(pos)
    all_bonds = list(bonds)
    if add_hydrogens:
        for i in range(nh):
            nfree = int(round(free(i)))
            for _ in range(max(0, nfree)):
                h_idx = len(all_types)
                all_types.append(1)
                d = rng.normal(size=3)
                # bias H away from the existing substituents
                away = pos[i] - np.mean([pos[j] for j in nbrs[i]], axis=0)
                d = d + 1.5 * away / (np.linalg.norm(away) + 1e-9)
                d /= np.linalg.norm(d)
                all_pos.append(pos[i] + d * 1.09)
                all_bonds.append((i, h_idx, int(BondType.SINGLE)))

    n = len(all_types)
    allpos = np.asarray(all_pos, np.float64)
    all_constraints = list(constraints) + [
        (i, j, 1.09) for i, j, t in all_bonds[len(bonds):]
    ]
    exclude_all = np.zeros((n, n), bool)
    for i, j, _ in all_constraints:
        exclude_all[i, j] = exclude_all[j, i] = True
    h_constraints = all_constraints[len(constraints):]
    allpos = _relax(allpos, all_constraints, exclude_all, iters=40,
                    step=0.03, repulse=1.4,
                    polish=bond_constraints + h_constraints)

    src, dst, types = [], [], []
    for i, j, t in all_bonds:
        src += [i, j]
        dst += [j, i]
        types += [t, t]
    order = np.lexsort((np.array(dst), np.array(src)))
    primary = allpos.astype(np.float32)
    primary = primary - primary.mean(0, keepdims=True)
    mol = Molecule(
        atom_type=np.array(all_types, np.int32),
        pos=primary,
        bond_index=np.stack([np.array(src)[order], np.array(dst)[order]]),
        bond_type=np.array(types, np.int32)[order],
        smiles=f"SYNR-{num_heavy}-{int(rng.integers(1 << 30))}",
    )
    mol.meta["ring_sizes"] = sizes
    mol.meta["num_aromatic"] = int(sum(aromatic))
    if num_conformers > 0:
        if multiref:  # distinct torsional modes, GEOM-like
            refs = [torsion_conformer(mol, rng, jitter=jitter)
                    for _ in range(num_conformers)]
        else:  # thermal jitters of the primary (byte-stable legacy mode)
            refs = [
                primary + rng.normal(scale=jitter,
                                     size=(n, 3)).astype(np.float32)
                for _ in range(num_conformers)
            ]
        mol.pos_ref = np.concatenate(refs, axis=0)
    return mol


def _bridges(n: int, edges: List[tuple]) -> set:
    """Indices into `edges` of the bridge edges (Tarjan low-link, iterative).
    In a tree every edge is a bridge; ring bonds are never bridges."""
    adj: List[List[tuple]] = [[] for _ in range(n)]
    for e, (i, j) in enumerate(edges):
        adj[i].append((j, e))
        adj[j].append((i, e))
    disc = [-1] * n
    low = [0] * n
    bridges: set = set()
    timer = 0
    for root in range(n):
        if disc[root] != -1:
            continue
        disc[root] = low[root] = timer
        timer += 1
        stack = [(root, -1, iter(adj[root]))]
        while stack:
            u, pe, it = stack[-1]
            pushed = False
            for v, e in it:
                if e == pe:
                    continue
                if disc[v] == -1:
                    disc[v] = low[v] = timer
                    timer += 1
                    stack.append((v, e, iter(adj[v])))
                    pushed = True
                    break
                low[u] = min(low[u], disc[v])
            if pushed:
                continue
            stack.pop()
            if stack:
                p = stack[-1][0]
                low[p] = min(low[p], low[u])
                if low[u] > disc[p]:
                    bridges.add(pe)
    return bridges


def torsion_conformer(mol: Molecule, rng: np.random.Generator,
                      jitter: float = 0.15,
                      relax_iters: int = 12) -> np.ndarray:
    """A genuinely DISTINCT conformer of the same molecular graph.

    Every rotatable bond — an acyclic (bridge) SINGLE bond with >= 2 atoms
    on each side — gets a fresh uniform torsion angle: the child side
    rotates rigidly around the bond axis, which exactly preserves all bond
    lengths, bond angles, and ring geometry while changing the dihedrals.
    A light constrained relax (soft repulsion; bond + second-neighbor
    distances projected back) removes steric clashes between the rotated
    arms, then thermal jitter is added.

    GEOM reference conformers are distinct torsional modes, not Gaussian
    jitters of one structure (the reference packs per-conformer data,
    datasets.py:1043-1061) — this is the synthetic analog, used by
    ``synthetic_dataset(multiref=True)`` for GEOM-faithful COV/MAT eval and
    by ``expand_conformers`` for per-conformer training data."""
    n = mol.num_nodes
    bi, bt = mol.bond_index, mol.bond_type
    uniq = bi[0] < bi[1]
    edges = list(zip(bi[0][uniq].tolist(), bi[1][uniq].tolist()))
    etype = bt[uniq]
    pos = mol.pos.astype(np.float64).copy()
    adj: List[List[tuple]] = [[] for _ in range(n)]
    for e, (i, j) in enumerate(edges):
        adj[i].append((j, e))
        adj[j].append((i, e))
    for e in sorted(_bridges(n, edges)):
        if int(etype[e]) != int(BondType.SINGLE):
            continue
        i, j = edges[e]
        comp = {j}
        work = [j]
        while work:  # j's side with the bridge removed
            u = work.pop()
            for v, e2 in adj[u]:
                if e2 != e and v not in comp:
                    comp.add(v)
                    work.append(v)
        if len(comp) < 2 or n - len(comp) < 2:
            continue  # terminal atom (e.g. H, halogen): rotation is a no-op
        axis = pos[j] - pos[i]
        axis /= np.linalg.norm(axis) + 1e-12
        th = rng.uniform(0.0, 2.0 * np.pi)
        c, s = np.cos(th), np.sin(th)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        R = np.eye(3) + s * K + (1.0 - c) * (K @ K)  # Rodrigues
        idx = np.fromiter(comp, np.int64)
        pos[idx] = pos[j] + (pos[idx] - pos[j]) @ R.T
    # declash: bonds + angle (second-neighbor) pairs are torsion-invariant,
    # so constraining them to their current distances preserves the local
    # geometry (incl. rings) while the soft repulsion separates clashed arms
    constraints = [(i, j, float(np.linalg.norm(pos[i] - pos[j])))
                   for i, j in edges]
    seen = {(i, j) for i, j in edges}
    for b in range(n):
        nb = [v for v, _ in adj[b]]
        for x in range(len(nb)):
            for y in range(x + 1, len(nb)):
                a, c2 = min(nb[x], nb[y]), max(nb[x], nb[y])
                if (a, c2) not in seen:
                    seen.add((a, c2))
                    constraints.append(
                        (a, c2, float(np.linalg.norm(pos[a] - pos[c2]))))
    exclude = np.zeros((n, n), bool)
    for i, j, _ in constraints:
        exclude[i, j] = exclude[j, i] = True
    pos = _relax(pos, constraints, exclude, iters=relax_iters,
                 step=0.03, repulse=1.4, polish=constraints[:len(edges)])
    out = pos.astype(np.float32)
    if jitter:
        out = out + rng.normal(scale=jitter, size=out.shape).astype(
            np.float32)
    return out - out.mean(0, keepdims=True)


def expand_conformers(mols: List[Molecule], num_conformers: int,
                      seed: int = 0, jitter: float = 0.0) -> List[Molecule]:
    """GEOM-style training expansion: each molecule contributes
    `num_conformers` datapoints — its primary geometry plus distinct torsion
    conformers of the same graph (the reference trains on per-conformer
    entries, datasets.py ConformationDataset over packed pickles). Conformers
    share the graph arrays and smiles, so PackedConformationDataset re-packs
    them and molecule-level train/val splits stay leak-free when applied
    BEFORE expansion."""
    rng = np.random.default_rng(seed)
    out: List[Molecule] = []
    for m in mols:
        out.append(m)
        for _ in range(max(0, num_conformers - 1)):
            out.append(Molecule(
                atom_type=m.atom_type, pos=torsion_conformer(
                    m, rng, jitter=jitter),
                bond_index=m.bond_index, bond_type=m.bond_type,
                smiles=m.smiles, meta=dict(m.meta),
            ))
    return out


def synthetic_dataset(
    num_molecules: int,
    seed: int = 0,
    min_heavy: int = 4,
    max_heavy: int = 9,
    num_conformers: int = 0,
    rigid: bool = False,
    chem: str = "tree",
    multiref: bool = False,
) -> List[Molecule]:
    """chem='tree' (default): the byte-stable single-bond tree generator;
    chem='rich': rings + DOUBLE/TRIPLE/AROMATIC bonds + S/Cl heteroatoms
    (GEOM-like structural diversity). rigid applies to 'tree' only.
    multiref: reference conformers are distinct torsion conformers
    (torsion_conformer) instead of jitters of the primary — the GEOM-
    faithful COV/MAT eval protocol; default off for byte-stability of the
    legacy arms."""
    if chem not in ("tree", "rich"):
        raise ValueError(f"unknown synthetic chemistry: {chem!r}")
    if chem == "rich" and rigid:
        raise ValueError("rigid geometry is a 'tree' generator mode")
    rng = np.random.default_rng(seed)
    make = random_molecule if chem == "tree" else random_rich_molecule
    kw = dict(rigid=rigid) if chem == "tree" else {}
    return [
        make(
            rng,
            num_heavy=int(rng.integers(min_heavy, max_heavy + 1)),
            num_conformers=num_conformers,
            multiref=multiref,
            **kw,
        )
        for _ in range(num_molecules)
    ]
