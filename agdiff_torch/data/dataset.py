"""Datasets and the training loader (port of agdiff_tpu/data/dataset.py).

ConformationDataset holds one entry per conformer; PackedConformationDataset
one per molecule, its reference conformers stacked in pos_ref (packed by
SMILES, or by meta['idx'], in first-seen order, as the reference packs,
datasets.py:1043-1061). Both read the .npz molecule format of
chem/mol.save_molecules and the reference's .pkl datasets (lists of PyG
Data, data/geom.py; a pickle holding RDKit objects needs RDKit and
raises).

BucketedLoader draws training batches on the host with numpy's
default_rng(seed), as the JAX loader does, so one seed gives the same
batches in the same order in both packages; its state (the generator and
the per-bucket cursors) is saved in a checkpoint, so a resumed run draws
what the uninterrupted one would have.
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from agdiff_torch.chem.mol import Molecule, load_molecules
from agdiff_torch.data.bucketing import group_by_bucket, pad_molecules
from agdiff_torch.data.graph_batch import GraphBatch


def _load_any(path: str) -> List[Molecule]:
    if path.endswith(".npz"):
        return load_molecules(path)
    if path.endswith(".pkl"):
        from agdiff_torch.data.geom import load_reference_pickle

        return load_reference_pickle(path)
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


class BucketedLoader:
    """Shuffled batches (bucket, GraphBatch) on the host, one a
    `next_batch()`, without end (agdiff_tpu/data/dataset.py:112-186; the
    JAX loader's __iter__). Each draw picks a bucket with
    probability proportional to its population, then takes batch_size
    molecules from that bucket's shuffled order, reshuffled when it runs
    out; every batch has one static shape."""

    def __init__(self, dataset: ConformationDataset, batch_size: int,
                 buckets: Sequence[int] = (32, 64), edge_order: int = 3,
                 seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.edge_order = edge_order
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.groups = group_by_bucket(dataset.molecules, buckets)
        self.bucket_sizes = sorted(self.groups)
        pops = np.array([len(self.groups[b]) for b in self.bucket_sizes],
                        float)
        self.bucket_probs = pops / pops.sum()
        self._perm = {b: self.rng.permutation(self.groups[b])
                      for b in self.bucket_sizes}
        self._cursor = {b: 0 for b in self.bucket_sizes}

    def _draw(self, bucket: int, count: int) -> List[int]:
        out: List[int] = []
        while len(out) < count:
            perm, cur = self._perm[bucket], self._cursor[bucket]
            take = min(count - len(out), len(perm) - cur)
            out.extend(perm[cur:cur + take].tolist())
            self._cursor[bucket] = cur + take
            if self._cursor[bucket] >= len(perm):
                self._perm[bucket] = (
                    self.rng.permutation(self.groups[bucket])
                    if self.shuffle else np.array(self.groups[bucket]))
                self._cursor[bucket] = 0
        return out

    def next_batch(self) -> Tuple[int, GraphBatch]:
        bucket = int(self.rng.choice(self.bucket_sizes, p=self.bucket_probs))
        mols = [self.dataset[i] for i in self._draw(bucket, self.batch_size)]
        return bucket, pad_molecules(mols, bucket, self.edge_order,
                                     batch_size=self.batch_size)

    def state_dict(self) -> Dict[str, Any]:
        """The draw state: the generator and each bucket's order and
        cursor (orders are replaced, never changed in place)."""
        return {"rng": copy.deepcopy(self.rng.bit_generator.state),
                "perm": dict(self._perm), "cursor": dict(self._cursor)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.rng.bit_generator.state = copy.deepcopy(state["rng"])
        self._perm = {int(b): np.asarray(p) for b, p in state["perm"].items()}
        self._cursor = {int(b): int(c) for b, c in state["cursor"].items()}

    def epoch_batches(self) -> Iterator[Tuple[int, GraphBatch]]:
        """One pass over the dataset in order (validation); the last
        partial batch of a bucket is padded with empty graphs unless
        drop_last (and it is not the bucket's first)."""
        for bucket in self.bucket_sizes:
            idxs = self.groups[bucket]
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start:start + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last \
                        and start > 0:
                    continue
                mols = [self.dataset[i] for i in chunk]
                yield bucket, pad_molecules(mols, bucket, self.edge_order,
                                            batch_size=self.batch_size)


def prefetch(iterator, size: int = 2, pin: bool = False):
    """Items of `iterator` made on a background thread, `size` ahead, so
    host collation overlaps the device's work; with pin, every tensor of
    an item's GraphBatch is moved to pinned memory there (a copy to the
    card can then run without blocking the host)."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def pinned(item):
        if not pin:
            return item
        return tuple(GraphBatch(**{k: v.pin_memory()
                                   for k, v in vars(x).items()})
                     if isinstance(x, GraphBatch) else x for x in item)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    failed = []

    def producer():
        try:
            for item in iterator:
                if not put(pinned(item)):
                    return
        except Exception as e:  # raised again in the consumer's thread
            failed.append(e)
        put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if failed:
                    raise failed[0]
                return
            yield item
    finally:
        # the producer leaves within its current item: a process may end
        # right after this, and must not end inside the producer's work
        stop.set()
        thread.join()
