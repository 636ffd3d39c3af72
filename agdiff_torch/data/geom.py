"""The reference's .pkl datasets (port of agdiff_tpu/data/geom.py:33-129,
load_reference_pickle).

A reference dataset pickle is a list of PyG `Data` objects. It is read
without torch_geometric: an unpickler resolves every torch_geometric
class to a shim that keeps the pickled attributes, and each shim becomes
a chem.mol.Molecule (tensors as numpy). Both layouts load: PyG 1.x keeps
the attributes on the object, PyG 2.x in `_store._mapping`. Labels
totalenergy, boltzmannweight and idx go to `meta`, as floats.

A pickle that holds RDKit objects (the GEOM sets' `rdmol`) needs RDKit to
be read, in this package as in the JAX one, and fails naming it: the
port has no RDKit.
"""

from __future__ import annotations

import pickle
from typing import List

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
                "it needs RDKit, as agdiff_tpu/data/geom.py does, and the "
                "port has none; convert the set to .npz where RDKit is "
                "installed (python -m agdiff_tpu.cli.preprocess convert)",
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
