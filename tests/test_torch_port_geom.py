"""The reference's .pkl datasets (agdiff_torch/data/geom.py) against the
JAX package's reader (agdiff_tpu/data/geom.py:33-129) on the CPU: pickles
of PyG Data in the 1.x and 2.x layouts, written with stub
torch_geometric classes as tests/test_data_interop.py writes them, load
to the same molecules field by field (tensors as numpy); the datasets
read a .pkl; a pickle holding RDKit objects fails in both packages, the
port's error naming RDKit; and `cli.generate` reads a .pkl test set."""

import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from agdiff_tpu.data.dataset import (
    ConformationDataset as JaxDataset,
    PackedConformationDataset as JaxPacked,
)
from agdiff_tpu.data.geom import load_reference_pickle as jax_load
from agdiff_tpu.eval.generate import load_samples as jax_load_samples

from agdiff_torch.cli import generate as gen_cli
from agdiff_torch.data.dataset import (
    ConformationDataset,
    PackedConformationDataset,
)
from agdiff_torch.data.geom import load_reference_pickle
from agdiff_torch.models.reference_checkpoint import (
    export_reference_state_dict,
)

from test_data_interop import (
    _fake_pyg_class,
    _make_legacy_data,
    _make_pyg2_data,
)
from test_torch_port_common import SMALL, configs, molecules, port_model
from test_torch_port_common import jax_variables, batches


def legacy_of(mol, **labels):
    """A PyG 1.x Data of a molecule (attributes on the object)."""
    Data = _fake_pyg_class("torch_geometric.data.data", "Data")
    d = Data()
    d.atom_type = torch.from_numpy(np.asarray(mol.atom_type, np.int64))
    d.pos = torch.from_numpy(np.asarray(mol.pos, np.float32))
    d.edge_index = torch.from_numpy(np.asarray(mol.bond_index, np.int64))
    d.edge_type = torch.from_numpy(np.asarray(mol.bond_type, np.int64))
    d.smiles = mol.smiles
    for k, v in labels.items():
        setattr(d, k, torch.tensor([v]))
    return d


def _dump(path, objs):
    with open(path, "wb") as f:
        pickle.dump(objs, f)
    return str(path)


def _same(a, b):
    for name in ("atom_type", "pos", "bond_index", "bond_type", "pos_ref"):
        x, y = getattr(a, name), getattr(b, name)
        if y is None:
            assert x is None, name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.smiles == b.smiles and a.meta == b.meta


@pytest.mark.parametrize("layout", ["pyg1", "pyg2", "molecules"])
def test_reference_pickle_matches_jax(tmp_path, layout):
    if layout == "pyg1":
        objs = [_make_legacy_data() for _ in range(3)]
    elif layout == "pyg2":
        objs = [_make_pyg2_data() for _ in range(2)]
    else:
        objs = [legacy_of(m, idx=i, totalenergy=-1.5 * i,
                          boltzmannweight=0.1 * i)
                for i, m in enumerate(molecules(3, seed=13))]
    path = _dump(tmp_path / f"{layout}.pkl", objs)
    got, want = load_reference_pickle(path), jax_load(path)
    assert len(got) == len(want) == len(objs)
    for a, b in zip(got, want):
        _same(a, b)
    assert isinstance(got[0].pos, np.ndarray)


def test_datasets_read_pkl(tmp_path):
    """ConformationDataset and PackedConformationDataset on a .pkl of two
    conformers of each of two molecules give JAX's entries (packed by
    SMILES, in first-seen order)."""
    mols = molecules(2, seed=13)
    objs = []
    for c in range(2):
        for i, m in enumerate(mols):
            d = legacy_of(m, idx=i)
            d.pos = d.pos + 0.1 * c
            objs.append(d)
    path = _dump(tmp_path / "set.pkl", objs)
    for port_cls, jax_cls in ((ConformationDataset, JaxDataset),
                              (PackedConformationDataset, JaxPacked)):
        got, want = port_cls(path), jax_cls(path)
        assert len(got) == len(want)
        assert got.atom_types == list(want.atom_types)
        for a, b in zip(got.molecules, want.molecules):
            _same(a, b)
    assert PackedConformationDataset(path).num_refs(0) == 2


def test_rdkit_pickle_fails_naming_rdkit(tmp_path):
    """A Data holding an RDKit object (the GEOM sets' rdmol) cannot be
    read without RDKit, in either package."""
    d = _make_legacy_data()
    names = ["rdkit", "rdkit.Chem", "rdkit.Chem.rdchem"]
    saved = {n: sys.modules.get(n) for n in names}
    try:
        for n in names:
            sys.modules[n] = types.ModuleType(n)
        d.rdmol = _fake_pyg_class("rdkit.Chem.rdchem", "Mol")()
        path = _dump(tmp_path / "rd.pkl", [d])
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
    with pytest.raises(ModuleNotFoundError, match="RDKit"):
        load_reference_pickle(path)
    with pytest.raises(ModuleNotFoundError):
        jax_load(path)


def test_cli_generates_from_a_pkl_test_set(tmp_path):
    """cli.generate with --test_set <.pkl> on the CPU ('pksf', K1's plain
    version): one sample file per molecule, which JAX's load_samples
    reads, with the pickle's atoms."""
    jcfg, cfg = configs()
    mols = molecules(2, seed=13)
    jb, _ = batches(mols, 16)
    _, variables = jax_variables(jcfg, jb)
    ckpt = str(tmp_path / "model.pt")
    torch.save({"model": export_reference_state_dict(
        port_model(cfg, variables)), "config": {"model": dict(SMALL)}},
        ckpt)
    test_set = _dump(tmp_path / "test.pkl",
                     [legacy_of(m, idx=i) for i, m in enumerate(mols)])
    out = tmp_path / "samples"
    gen_cli.main([ckpt, "--test_set", test_set, "--out_dir", str(out),
                  "--fast", "--engine", "pksf", "--n_steps", "2",
                  "--num_confs", "2", "--chunk_size", "4", "--device",
                  "cpu"])
    got = jax_load_samples(str(out / "samples_all.npz"))
    assert len(got) == 2 and os.path.exists(out / "samples_1.npz")
    for mol, g in zip(mols, got):
        np.testing.assert_array_equal(g.atom_type, mol.atom_type)
        pg = g.meta["pos_gen"]
        assert pg.shape == (2, mol.num_nodes, 3) and np.isfinite(pg).all()
