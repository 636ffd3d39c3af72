"""The reference's .pkl datasets and the GEOM preprocessing (port of
agdiff_tpu/data/geom.py; reference: src/agdiff/utils/datasets.py).

A reference dataset pickle is a list of PyG `Data` objects. It is read
without torch_geometric: an unpickler resolves every torch_geometric
class to a shim that keeps the pickled attributes, and each shim becomes
a chem.mol.Molecule (tensors as numpy). Both layouts load: PyG 1.x keeps
the attributes on the object, PyG 2.x in `_store._mapping`. Labels
totalenergy, boltzmannweight and idx go to `meta`, as floats. A pickle
that holds RDKit objects (the GEOM sets' `rdmol`) needs RDKit to be read,
and fails naming it where RDKit is missing.

The GEOM preprocessing reads the raw GEOM dump (summary_<qm9|drugs>.json
and one pickle of RDKit conformers per molecule) and needs RDKit
(chem/rdkit_bridge.py), which each function asks for before it reads
anything:
  * preprocess_geom_fixed_num_conf: conf_per_mol Boltzmann-top conformers
    of tot_mol_size molecules, a train/val/test split by molecule index,
    totalenergy/boltzmannweight/idx labels (datasets.py:559-710);
  * preprocess_geom: the top max_conf conformers, a random split in
    meta['split'] (datasets.py:441-556);
  * get_test_set_with_large_num_conf: molecules of min_conf..max_conf
    conformers outside a block list, every conformer packed in pos_ref
    (datasets.py:713-825);
  * preprocess_iso17 (datasets.py:402-438).
They draw from Python's `random` and numpy's global generator, seeded as
the JAX package seeds them, so that one summary gives the same molecules
in the same splits in both packages.
"""

from __future__ import annotations

import json
import os
import pickle
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from agdiff_torch.chem.mol import Molecule


class _DataShim:
    """Stand-in for torch_geometric.data.Data (and its storages) during
    unpickling."""

    def __init__(self, *args, **kwargs):
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _ShimUnpickler(pickle.Unpickler):
    _SHIMMED_PREFIXES = ("torch_geometric",)

    def find_class(self, module, name):
        if any(module.startswith(p) for p in self._SHIMMED_PREFIXES):
            return _DataShim
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError as err:
            if module.split(".")[0] != "rdkit":
                raise
            raise ModuleNotFoundError(
                f"this pickle holds RDKit objects ({module}.{name}): reading "
                "it needs RDKit, which is not installed; install it, or "
                "convert the set to .npz where it is (python -m "
                "agdiff_torch.cli.preprocess convert)",
                name=err.name) from err


def _unshim_value(v):
    return v.numpy() if isinstance(v, torch.Tensor) else v


def _shim_to_molecule(obj) -> Molecule:
    d = obj.__dict__ if hasattr(obj, "__dict__") else dict(obj)
    # PyG >= 2 stores the attributes under _store
    for key in ("_store", "_mapping"):
        if key in d and hasattr(d[key], "__dict__"):
            inner = d[key].__dict__
            d = {**d, **inner.get("_mapping", inner)}
    flat = {}
    for k, v in d.items():
        if isinstance(v, dict):
            flat.update(v)
        else:
            flat[k] = v

    def get(*names):
        return next((_unshim_value(flat[n]) for n in names if n in flat),
                    None)

    atom_type = get("atom_type", "z")
    pos = get("pos")
    edge_index = get("edge_index")
    edge_type = get("edge_type")
    if atom_type is None or pos is None or edge_index is None:
        raise ValueError(f"unrecognized Data layout: keys={sorted(flat)}")
    meta = {}
    for label in ("totalenergy", "boltzmannweight", "idx"):
        v = get(label)
        if v is not None:
            meta[label] = float(np.asarray(v).reshape(-1)[0])
    pos_ref = get("pos_ref")
    return Molecule(
        atom_type=np.asarray(atom_type),
        pos=np.asarray(pos, np.float32),
        bond_index=np.asarray(edge_index),
        bond_type=np.asarray(edge_type if edge_type is not None
                             else np.ones(np.asarray(edge_index).shape[1])),
        pos_ref=None if pos_ref is None else np.asarray(pos_ref, np.float32),
        smiles=flat.get("smiles"),
        meta=meta,
    )


def load_reference_pickle(path: str) -> List[Molecule]:
    """Load a reference-format dataset pickle (a list of PyG Data)."""
    with open(path, "rb") as f:
        data_list = _ShimUnpickler(f).load()
    return [_shim_to_molecule(d) for d in data_list]


# --------------------------------------------------------------------------
# GEOM raw preprocessing (RDKit for the rd_mol objects)
# --------------------------------------------------------------------------

def _read_summary(base_path: str, dataset_name: str) -> Dict:
    if dataset_name not in ("qm9", "drugs"):
        raise ValueError(f"dataset_name must be qm9 or drugs, not "
                         f"{dataset_name!r}")
    with open(os.path.join(base_path, f"summary_{dataset_name}.json")) as f:
        return json.load(f)


def _mol_pickle_to_conformers(base_path: str, pickle_path: str
                              ) -> Optional[dict]:
    with open(os.path.join(base_path, pickle_path), "rb") as f:
        return pickle.load(f)


def _seed(seed: Optional[int]) -> None:
    seed = 2021 if seed is None else seed
    np.random.seed(seed)
    random.seed(seed)


def preprocess_geom_fixed_num_conf(
    base_path: str,
    dataset_name: str,
    conf_per_mol: int = 5,
    train_size: float = 0.8,
    tot_mol_size: int = 50000,
    seed: Optional[int] = None,
) -> Tuple[List[Molecule], List[Molecule], List[Molecule], Dict[int, str]]:
    """(train, val, test, index -> split) of tot_mol_size molecules with
    at least conf_per_mol unique conformers (datasets.py:559-710)."""
    from agdiff_torch.chem import rdkit_bridge

    rdkit_bridge.require_rdkit()
    _seed(seed)
    summ = _read_summary(base_path, dataset_name)
    pickle_path_list = []
    for meta_mol in summ.values():
        u_conf = meta_mol.get("uniqueconfs")
        pkl = meta_mol.get("pickle_path")
        if u_conf is None or pkl is None or u_conf < conf_per_mol:
            continue
        pickle_path_list.append(pkl)
    random.shuffle(pickle_path_list)
    if len(pickle_path_list) < tot_mol_size:
        raise ValueError(f"only {len(pickle_path_list)} molecules available "
                         f"(< tot_mol_size {tot_mol_size})")
    pickle_path_list = pickle_path_list[:tot_mol_size]

    split_indexes = list(range(tot_mol_size))
    random.shuffle(split_indexes)
    val_size = (1.0 - train_size) / 2
    n_train = int(tot_mol_size * train_size)
    n_val = int(tot_mol_size * (train_size + val_size))
    index2split: Dict[int, str] = {}
    for k, i in enumerate(split_indexes):
        index2split[i] = ("train" if k < n_train
                          else "val" if k < n_val else "test")

    splits: Dict[str, List[Molecule]] = {"train": [], "val": [], "test": []}
    for i, pkl in enumerate(pickle_path_list):
        mol = _mol_pickle_to_conformers(base_path, pkl)
        confs = mol.get("conformers")
        if mol.get("uniqueconfs") > len(confs) or \
                mol.get("uniqueconfs") <= 0:
            continue
        if mol.get("uniqueconfs") == conf_per_mol:
            conf_ids = np.arange(mol.get("uniqueconfs"))
        else:
            weights = np.array([c.get("boltzmannweight", -1.0)
                                for c in confs])
            conf_ids = (-weights).argsort()[:conf_per_mol]
        for cid in conf_ids:
            conf_meta = confs[cid]
            m = rdkit_bridge.rdmol_to_molecule(conf_meta.get("rd_mol"),
                                               smiles=mol.get("smiles"))
            m.meta = {"totalenergy": float(conf_meta["totalenergy"]),
                      "boltzmannweight": float(conf_meta["boltzmannweight"]),
                      "idx": int(i)}
            splits[index2split[i]].append(m)
    return splits["train"], splits["val"], splits["test"], index2split


def preprocess_geom(
    base_path: str,
    dataset_name: str,
    max_conf: int = 5,
    train_size: float = 0.8,
    max_size: int = 9999999999,
    seed: Optional[int] = None,
) -> List[Molecule]:
    """The top max_conf Boltzmann conformers of each molecule, each
    molecule's split drawn at random into meta['split']
    (datasets.py:441-556)."""
    from agdiff_torch.chem import rdkit_bridge

    rdkit_bridge.require_rdkit()
    _seed(seed)
    summ = _read_summary(base_path, dataset_name)
    items = [(s, m["pickle_path"]) for s, m in summ.items()
             if m.get("uniqueconfs") is not None and m.get("pickle_path")]
    random.shuffle(items)
    all_mols: List[Molecule] = []
    for _, pkl in items[:max_size]:
        try:
            mol = _mol_pickle_to_conformers(base_path, pkl)
        except FileNotFoundError:
            continue
        confs = mol.get("conformers", [])
        if not confs:
            continue
        weights = np.array([c.get("boltzmannweight", -1.0) for c in confs])
        conf_ids = (-weights).argsort()[:max_conf]
        split = np.random.choice(
            ["train", "val", "test"],
            p=[train_size, (1 - train_size) / 2, (1 - train_size) / 2])
        for cid in conf_ids:
            m = rdkit_bridge.rdmol_to_molecule(confs[cid].get("rd_mol"),
                                               smiles=mol.get("smiles"))
            m.meta = {"split": str(split)}
            all_mols.append(m)
    return all_mols


def get_test_set_with_large_num_conf(
    base_path: str,
    dataset_name: str,
    block: Optional[List[str]] = None,
    tot_mol_size: int = 1000,
    min_conf: int = 50,
    max_conf: int = 500,
    seed: Optional[int] = None,
) -> List[Molecule]:
    """The packed test set (datasets.py:713-825): up to tot_mol_size
    molecules of min_conf..max_conf unique conformers whose SMILES are
    not in `block`, each with all its conformers in pos_ref."""
    from agdiff_torch.chem import rdkit_bridge

    rdkit_bridge.require_rdkit()
    _seed(seed)
    block = set(block or [])
    summ = _read_summary(base_path, dataset_name)
    candidates = []
    for smiles, meta_mol in summ.items():
        u_conf = meta_mol.get("uniqueconfs")
        pkl = meta_mol.get("pickle_path")
        if u_conf is None or pkl is None:
            continue
        if u_conf < min_conf or u_conf > max_conf or smiles in block:
            continue
        candidates.append(pkl)
    random.shuffle(candidates)

    packed: List[Molecule] = []
    for i, pkl in enumerate(candidates):
        if len(packed) >= tot_mol_size:
            break
        mol = _mol_pickle_to_conformers(base_path, pkl)
        confs = mol.get("conformers", [])
        if not confs:
            continue
        base = rdkit_bridge.rdmol_to_molecule(confs[0].get("rd_mol"),
                                              smiles=mol.get("smiles"))
        base.pos_ref = np.concatenate(
            [np.asarray(c["rd_mol"].GetConformer(0).GetPositions(),
                        np.float32) for c in confs], axis=0)
        base.meta = {"idx": int(i), "num_confs": len(confs)}
        packed.append(base)
    return packed


def preprocess_iso17(base_path: str) -> Tuple[List[Molecule], List[Molecule]]:
    """ISO17 (datasets.py:402-438): iso17_split-0_{train,test}.pkl, lists
    of RDKit molecules, -> (train, test) Molecule lists."""
    from agdiff_torch.chem import rdkit_bridge

    rdkit_bridge.require_rdkit()
    out = []
    for split in ("train", "test"):
        with open(os.path.join(base_path, f"iso17_split-0_{split}.pkl"),
                  "rb") as f:
            raw = pickle.load(f)
        out.append([rdkit_bridge.rdmol_to_molecule(m) for m in raw])
    return tuple(out)
