"""Everything around RDKit and psi4 in the port (chem/rdkit_bridge.py,
data/geom.py's GEOM preprocessing, cli/preprocess.py, COV/MAT's force
field, cli/smiles_generation.py, eval/properties.py, cli/eval_prop.py)
against the JAX package on the CPU, where neither RDKit nor psikit is
installed. Both packages get the same stand-in at the seam: the
functions that call RDKit (rdmol_to_molecule, molecule_to_rdmol,
smiles_to_molecule, mmff_optimize_positions, write_sdf; in the port also
require_rdkit, its up-front check) are replaced in both bridges by one
function over plain, picklable stand-in molecules, and psikit by a fake
module whose properties follow from the positions. Without the stand-ins
every entry point raises ImportError naming the missing package. True
RDKit round trips run where RDKit is installed and skip elsewhere."""

import importlib.util
import json
import logging
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from agdiff_tpu.chem import rdkit_bridge as jax_bridge
from agdiff_tpu.chem.mol import Molecule as JaxMolecule
from agdiff_tpu.chem.mol import load_molecules as jax_load_molecules
from agdiff_tpu.cli import eval_prop as jax_eval_prop
from agdiff_tpu.cli import preprocess as jax_preprocess
from agdiff_tpu.cli import smiles_generation as jax_smiles
from agdiff_tpu.data import geom as jax_geom
from agdiff_tpu.data.synthetic import synthetic_dataset
from agdiff_tpu.eval import covmat as jax_covmat
from agdiff_tpu.eval import properties as jax_properties
from agdiff_tpu.eval.generate import _save_all as jax_save_all

from agdiff_torch.chem import rdkit_bridge
from agdiff_torch.chem.mol import Molecule, load_molecules
from agdiff_torch.cli import eval_prop, preprocess, smiles_generation
from agdiff_torch.config import ModelConfig
from agdiff_torch.data import geom
from agdiff_torch.eval import covmat, properties
from agdiff_torch.eval.generate import load_samples
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.reference_checkpoint import (
    export_reference_state_dict,
)
from agdiff_torch.models.weights import init_random

from test_torch_port_common import SMALL
from test_torch_port_geom import legacy_of

FIELDS = ("atom_type", "pos", "bond_index", "bond_type", "pos_ref")


# ---- the stand-ins ---------------------------------------------------------

class StandInConformer:
    def __init__(self, pos):
        self.pos = np.asarray(pos, np.float64)

    def GetPositions(self):
        return self.pos


class StandInMol:
    """A picklable stand-in for an RDKit Mol with one conformer."""

    def __init__(self, atom_type, pos, bonds, bond_types, smiles=None):
        self.atom_type = np.asarray(atom_type, np.int32)
        self.pos = np.asarray(pos, np.float64)
        self.bonds = np.asarray(bonds, np.int64).reshape(-1, 2)
        self.bond_types = np.asarray(bond_types, np.int32)
        self.smiles = smiles

    def GetConformer(self, i=0):
        assert i == 0
        return StandInConformer(self.pos)


def stand_in_mol(mol, pos=None):
    pairs, types = mol.undirected_bonds()
    return StandInMol(mol.atom_type, mol.pos if pos is None else pos, pairs,
                      types, mol.smiles)


def stand_ins(molecule_cls, sdf_calls):
    """The seam's functions, building `molecule_cls` (each package's
    Molecule)."""

    def rdmol_to_molecule(mol, smiles=None):
        n = len(mol.atom_type)
        row = np.concatenate([mol.bonds[:, 0], mol.bonds[:, 1]])
        col = np.concatenate([mol.bonds[:, 1], mol.bonds[:, 0]])
        types = np.concatenate([mol.bond_types, mol.bond_types])
        order = np.argsort(row * n + col)
        return molecule_cls(
            atom_type=mol.atom_type, pos=mol.pos.astype(np.float32),
            bond_index=np.stack([row[order], col[order]]),
            bond_type=types[order],
            smiles=mol.smiles if smiles is None else smiles)

    def smiles_to_molecule(smiles, seed=2021):
        base = synthetic_dataset(1, seed=seed + len(smiles), min_heavy=4,
                                 max_heavy=6)[0]
        return rdmol_to_molecule(stand_in_mol(base), smiles=smiles)

    def mmff_optimize_positions(mol, pos):
        pos = np.asarray(pos, np.float32)
        return (0.9 * pos + 0.1 * pos.mean(0)).astype(np.float32)

    def write_sdf(path, mol, conformers):
        sdf_calls.append((path, np.asarray(mol.atom_type).copy(),
                          np.asarray(conformers).copy()))

    return dict(rdmol_to_molecule=rdmol_to_molecule,
                molecule_to_rdmol=stand_in_mol,
                smiles_to_molecule=smiles_to_molecule,
                mmff_optimize_positions=mmff_optimize_positions,
                write_sdf=write_sdf)


class FakePsikit:
    """psikit.Psikit's surface: properties of the positions; about a
    third of the conformers (by the digits of their positions) do not
    converge."""

    def __init__(self, threads=8, memory=16):
        self.mol = None

    def energy(self):
        p = self.mol.pos
        if int(np.abs(p).sum() * 1000) % 3 == 0:
            raise RuntimeError("SCF did not converge")
        return -40.0 - 0.01 * float(np.abs(p).sum())

    @property
    def HOMO(self):
        return -0.3 - 0.001 * float(self.mol.pos[:, 1].sum())

    @property
    def LUMO(self):
        return 0.05 + 0.001 * float(self.mol.pos[:, 2].sum())

    @property
    def dipolemoment(self):
        d = self.mol.pos.mean(0)
        return (*d, float(np.linalg.norm(d)))


@pytest.fixture
def seam(monkeypatch):
    """The stand-ins in both bridges and a fake psikit; yields each
    package's recorded SDF writes."""
    calls = {"jax": [], "port": []}
    for name, bridge, cls in (("jax", jax_bridge, JaxMolecule),
                              ("port", rdkit_bridge, Molecule)):
        for fn_name, fn in stand_ins(cls, calls[name]).items():
            monkeypatch.setattr(bridge, fn_name, fn)
    monkeypatch.setattr(rdkit_bridge, "require_rdkit", lambda: None)
    fake = types.ModuleType("psikit")
    fake.Psikit = FakePsikit
    monkeypatch.setitem(sys.modules, "psikit", fake)
    monkeypatch.setenv("AGDIFF_CACHE_DIR", "off")
    return calls


def assert_same(got, want, meta=True):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, f
                np.testing.assert_array_equal(x, y, err_msg=f)
        assert a.smiles == b.smiles
        if meta:
            assert a.meta == b.meta


# ---- GEOM preprocessing ----------------------------------------------------

@pytest.fixture(scope="module")
def geom_dump(tmp_path_factory):
    """A GEOM-shaped dump: summary_qm9.json and one pickle per molecule
    (uniqueconfs, smiles, conformers of stand-in Mols with totalenergy and
    boltzmannweight). Molecules of 1 to 9 conformers; two without a
    pickle_path, one with uniqueconfs above its conformers (skipped), one
    of one conformer whose pickle is missing (preprocess_geom skips it,
    the others never read it)."""
    base = tmp_path_factory.mktemp("geom")
    os.makedirs(base / "qm9")
    rng = np.random.default_rng(3)
    mols = synthetic_dataset(24, seed=11, min_heavy=3, max_heavy=6)
    summary = {}
    for i, m in enumerate(mols):
        smiles = f"SYN{i}"
        k = 1 if i == 20 else int(rng.integers(1, 10))
        confs = []
        for c in range(k):
            pos = m.pos + rng.normal(0, 0.3, m.pos.shape)
            confs.append({"rd_mol": stand_in_mol(m, pos),
                          "totalenergy": float(-10 - rng.random()),
                          "boltzmannweight": float(rng.random())})
        path = f"qm9/mol{i}.pickle"
        entry = {"uniqueconfs": k, "pickle_path": path}
        if i in (5, 17):
            entry.pop("pickle_path")
        summary[smiles] = entry
        unique = k + 3 if i == 8 else k
        if i != 20:
            with open(base / path, "wb") as f:
                pickle.dump({"smiles": smiles, "uniqueconfs": unique,
                             "conformers": confs}, f)
    with open(base / "summary_qm9.json", "w") as f:
        json.dump(summary, f)
    iso = synthetic_dataset(4, seed=12, min_heavy=3, max_heavy=5)
    for split, part in (("train", iso[:3]), ("test", iso[3:])):
        with open(base / f"iso17_split-0_{split}.pkl", "wb") as f:
            pickle.dump([stand_in_mol(m) for m in part], f)
    return str(base)


@pytest.mark.parametrize("seed", [None, 5])
def test_geom_preprocessing_matches_jax(seam, geom_dump, seed):
    """The same molecules in the same splits: the fixed-count split (the
    index -> split map too), the random-split variant and the packed
    large-conformer test set with a block list."""
    kw = dict(conf_per_mol=3, tot_mol_size=12, train_size=0.5, seed=seed)
    *got, got_map = geom.preprocess_geom_fixed_num_conf(geom_dump, "qm9",
                                                        **kw)
    *want, want_map = jax_geom.preprocess_geom_fixed_num_conf(geom_dump,
                                                              "qm9", **kw)
    assert got_map == want_map
    assert sum(len(s) for s in got) > 0
    for g, w in zip(got, want, strict=True):
        assert_same(g, w)
    kw = dict(max_conf=2, train_size=0.6, max_size=15, seed=seed)
    got = geom.preprocess_geom(geom_dump, "qm9", **kw)
    want = jax_geom.preprocess_geom(geom_dump, "qm9", **kw)
    assert len({m.meta["split"] for m in got}) > 1
    assert_same(got, want)
    kw = dict(block=["SYN1", "SYN2"], tot_mol_size=4, min_conf=4,
              max_conf=8, seed=seed)
    got = geom.get_test_set_with_large_num_conf(geom_dump, "qm9", **kw)
    want = jax_geom.get_test_set_with_large_num_conf(geom_dump, "qm9", **kw)
    assert len(got) == 4 and all(m.num_ref >= 4 for m in got)
    assert_same(got, want)


def test_iso17_and_cli_geom_match_jax(seam, geom_dump, tmp_path):
    for g, w in zip(geom.preprocess_iso17(geom_dump),
                    jax_geom.preprocess_iso17(geom_dump), strict=True):
        assert_same(g, w)
    args = ["geom", "--base_path", geom_dump, "--dataset", "qm9",
            "--conf_per_mol", "2", "--tot_mol_size", "10", "--seed", "7",
            "--test_min_conf", "3", "--test_max_conf", "9",
            "--test_mol_size", "5"]
    preprocess.main(args + ["--out_dir", str(tmp_path / "port")])
    jax_preprocess.main(args + ["--out_dir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert names == ["test_data_5k.npz", "test_data_large_conf.npz",
                     "train_data_0k.npz", "val_data_5k.npz"]
    for name in names:
        got = load_molecules(str(tmp_path / "port" / name))
        assert_same(got, load_molecules(str(tmp_path / "jax" / name)))
        assert_same(got, jax_load_molecules(str(tmp_path / "port" / name)))


def test_cli_convert_matches_jax(tmp_path, monkeypatch):
    """convert on a reference .pkl (PyG 1.x Data with labels): the two
    .npz files load to the same molecules, in either package."""
    monkeypatch.setenv("AGDIFF_CACHE_DIR", "off")
    mols = synthetic_dataset(3, seed=13, min_heavy=3, max_heavy=5)
    src = tmp_path / "set.pkl"
    with open(src, "wb") as f:
        pickle.dump([legacy_of(m, idx=i, totalenergy=-1.5 * i)
                     for i, m in enumerate(mols)], f)
    preprocess.main(["convert", str(src), str(tmp_path / "port.npz")])
    jax_preprocess.main(["convert", str(src), str(tmp_path / "jax.npz")])
    got = load_molecules(str(tmp_path / "port.npz"))
    assert len(got) == 3 and got[2].meta == {"idx": 2.0, "totalenergy": -3.0}
    assert_same(got, load_molecules(str(tmp_path / "jax.npz")))
    assert_same(jax_load_molecules(str(tmp_path / "port.npz")), got)


# ---- COV/MAT with the force field --------------------------------------------

@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """A samples_all.npz of three molecules, 3 references and 7 generated
    conformers each (one of them with a disconnected SMILES)."""
    rng = np.random.default_rng(4)
    out = []
    for k, m in enumerate(synthetic_dataset(3, seed=9, min_heavy=4,
                                            max_heavy=6)):
        n = m.num_nodes
        refs = m.pos[None] + rng.normal(0, 0.2, (3, n, 3))
        gens = refs[rng.integers(0, 3, 7)] + rng.normal(0, 0.3, (7, n, 3))
        out.append(JaxMolecule(
            atom_type=m.atom_type, pos=m.pos, bond_index=m.bond_index,
            bond_type=m.bond_type, pos_ref=refs.reshape(-1, 3),
            smiles="C.C" if k == 1 else m.smiles,
            meta={"pos_gen": gens.astype(np.float32)}))
    path = tmp_path_factory.mktemp("ff") / "samples_all.npz"
    jax_save_all(str(path), out)
    return str(path)


@pytest.mark.parametrize("use_native", [False, True])
def test_covmat_force_field_matches_jax(seam, samples, use_native):
    from agdiff_tpu.eval.generate import load_samples as jax_load_samples

    quiet = dict(num_workers=1, print_fn=lambda *a: None)
    want = jax_covmat.CovMatEvaluator(use_force_field=True, **quiet)(
        jax_load_samples(samples))
    got = covmat.CovMatEvaluator(use_force_field=True, use_native=use_native,
                                 **quiet)(load_samples(samples))
    plain = covmat.CovMatEvaluator(**quiet)(load_samples(samples))
    for name in ("CoverageR", "MatchingR", "CoverageP", "MatchingP"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-12, err_msg=name)
    assert got.MatchingR.shape == (2,)
    # the relaxation moved the generated conformers
    assert not np.allclose(got.MatchingR, plain.MatchingR)


# ---- properties ---------------------------------------------------------------

def test_properties_match_jax(seam):
    """The shuffled conformer choice, the outputs (a non-converging
    conformer skipped), the ensemble statistics and their comparison."""
    mols = synthetic_dataset(2, seed=6, min_heavy=4, max_heavy=6,
                             num_conformers=9, multiref=True)
    got_calc = properties.PropertyCalculator(seed=3)
    want_calc = jax_properties.PropertyCalculator(seed=3)
    outs = []
    for m in mols:
        confs = m.pos_ref.reshape(-1, m.num_nodes, 3)
        for num in (4, 50):
            got = got_calc(Molecule.from_arrays(m.to_arrays()), confs, num)
            want = want_calc(m, confs, num)
            assert got == want
            outs.append(got)
    assert len(outs[1]["conf_idx"]) < 9 or len(outs[3]["conf_idx"]) < 9
    assert properties.HARTREE_TO_EV == jax_properties.HARTREE_TO_EV
    assert properties.ensemble_statistics(outs[1]) == \
        jax_properties.ensemble_statistics(outs[1])
    assert properties.compare_ensembles(outs[1], outs[3]) == \
        jax_properties.compare_ensembles(outs[1], outs[3])


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_cli_eval_prop_matches_jax(seam, samples):
    """The per-molecule lines and the MAE table, message for message (the
    two packages log through the logger of one name)."""
    handler = _Records()
    logger = logging.getLogger("eval_prop")
    logger.addHandler(handler)
    try:
        args = [samples, "--num_confs", "5", "--seed", "1"]
        jax_eval_prop.main(args)
        want, handler.lines = handler.lines, []
        eval_prop.main(args)
        got = handler.lines
    finally:
        logger.removeHandler(handler)
    assert got == want
    assert got[-4:-1] and "MAE over" in " ".join(got)


# ---- SMILES generation -------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A reference .pt of the small config's seeded weights."""
    path = str(tmp_path_factory.mktemp("smiles") / "model.pt")
    model = init_random(DualEncoderEpsNetwork(ModelConfig(**SMALL)), 0)
    torch.save({"model": export_reference_state_dict(model),
                "config": {"model": dict(SMALL)}}, path)
    return path


class _JaxRunner:
    """Stands in for JAX's GenerationRunner: records its arguments and
    returns zeros of the requested shape (no JAX ladder is compiled)."""

    made = []

    def __init__(self, model, variables, diffusion, scfg, **kw):
        self.scfg, self.kw = scfg, kw
        _JaxRunner.made.append(self)

    def generate_molecule(self, mol, num_samples, key):
        self.request = (mol.num_nodes, num_samples)
        return np.zeros((num_samples, mol.num_nodes, 3), np.float32)


@pytest.mark.parametrize("num_samples", ["auto", "12"])
def test_smiles_generation_matches_jax(seam, tiny_checkpoint, tmp_path,
                                       monkeypatch, num_samples):
    """The port's CLI runs on the CPU (--fast: the f32 packed forward; 5
    steps); JAX's CLI runs with its checkpoint loading and runner stood
    in. Both parse the same stand-in molecule, ask the same sampler
    settings and sample count, and write one SDF of that many finite
    conformers. The random streams differ, so positions are not
    compared."""
    from agdiff_tpu.config import Config as JaxConfig
    from agdiff_tpu.config import ModelConfig as JaxModelConfig
    from agdiff_tpu.eval import generate as jax_generate
    from agdiff_tpu.train import checkpoint as jax_checkpoint

    monkeypatch.setattr(jax_checkpoint, "load_checkpoint", lambda p: {
        "config": JaxConfig(model=JaxModelConfig(**SMALL)), "params": {},
        "batch_stats": {}})
    monkeypatch.setattr(jax_generate, "GenerationRunner", _JaxRunner)
    _JaxRunner.made.clear()
    made = []
    real = smiles_generation.__dict__.get("GenerationRunner")
    assert real is None   # imported at call time, from eval/generate.py
    from agdiff_torch.eval import generate as port_generate

    class Recording(port_generate.GenerationRunner):
        def __init__(self, *a, **kw):
            made.append((a, kw))
            super().__init__(*a, **kw)

    monkeypatch.setattr(port_generate, "GenerationRunner", Recording)
    args = ["--smiles", "CC(=O)O", "--num_samples", num_samples,
            "--n_steps", "5", "--w_global", "0.3", "--clip_local", "20",
            "--chunk_size", "128", "--fast"]
    got = smiles_generation.main([tiny_checkpoint, "--out_sdf",
                                  str(tmp_path / "port.sdf"), *args,
                                  "--device", "cpu"])
    jax_smiles.main([tiny_checkpoint, "--out_sdf", str(tmp_path / "jax.sdf"),
                     *args])
    (jpath, jz, jconfs), = seam["jax"]
    (path, z, confs), = seam["port"]
    runner = _JaxRunner.made[0]
    n = len(z)
    want_count = 5 * (1100 // n) if num_samples == "auto" else 12
    assert runner.request == (n, want_count)
    assert path == str(tmp_path / "port.sdf")
    np.testing.assert_array_equal(z, jz)
    assert confs.shape == jconfs.shape == (want_count, n, 3)
    assert np.isfinite(confs).all() and np.array_equal(confs, got)
    (margs, mkw), = made
    port_scfg, jax_scfg = margs[3], runner.scfg
    for f in ("n_steps", "step_lr", "w_global", "global_start_sigma", "clip",
              "clip_local"):
        assert getattr(port_scfg, f) == getattr(jax_scfg, f), f
    assert mkw["chunk_size"] == runner.kw["chunk_size"] == 128
    assert mkw["use_fast"] and runner.kw["use_fast"]


def test_smiles_generation_refuses_an_orbax_checkpoint(tmp_path):
    os.makedirs(tmp_path / "log" / "checkpoints" / "4" / "state")
    args = smiles_generation.parse_args([str(tmp_path / "log"), "--smiles",
                                         "C", "--out_sdf", "x.sdf"])
    mol = Molecule(atom_type=[6], pos=np.zeros((1, 3)),
                   bond_index=np.zeros((2, 0)), bond_type=[])
    with pytest.raises(FileNotFoundError, match="convert_jax_checkpoint"):
        smiles_generation.generate_for_molecule(str(tmp_path / "log"), mol,
                                                "auto", args, "cpu")


@pytest.mark.parametrize("n,want", [(1, 5500), (22, 250), (1100, 5),
                                    (2000, 5)])
def test_sample_count(n, want):
    assert smiles_generation.sample_count("auto", n) == want
    assert smiles_generation.sample_count("7", n) == 7


# ---- refusals without RDKit or psi4 ----------------------------------------------

def _no(package):
    if importlib.util.find_spec(package) is not None:
        pytest.skip(f"{package} is installed")


_MOL = Molecule(atom_type=[6, 8], pos=np.zeros((2, 3)),
                bond_index=[[0, 1], [1, 0]], bond_type=[1, 1])
ENTRY_POINTS = {
    "rdmol_to_molecule": lambda d: rdkit_bridge.rdmol_to_molecule(None),
    "molecule_to_rdmol": lambda d: rdkit_bridge.molecule_to_rdmol(_MOL),
    "smiles_to_molecule": lambda d: rdkit_bridge.smiles_to_molecule("CO"),
    "mmff_optimize_positions": lambda d: rdkit_bridge.mmff_optimize_positions(
        _MOL, _MOL.pos),
    "rdkit_best_rmsd": lambda d: rdkit_bridge.rdkit_best_rmsd(None, None),
    "write_sdf": lambda d: rdkit_bridge.write_sdf(str(d / "x.sdf"), _MOL,
                                                  _MOL.pos[None]),
    "mol_to_smiles": lambda d: rdkit_bridge.mol_to_smiles(None),
    "smiles_to_canonical": lambda d: rdkit_bridge.smiles_to_canonical("CO"),
    "draw_mol_image": lambda d: rdkit_bridge.draw_mol_image(None),
    "preprocess_geom_fixed_num_conf":
        lambda d: geom.preprocess_geom_fixed_num_conf(str(d), "qm9"),
    "preprocess_geom": lambda d: geom.preprocess_geom(str(d), "qm9"),
    "get_test_set_with_large_num_conf":
        lambda d: geom.get_test_set_with_large_num_conf(str(d), "qm9"),
    "preprocess_iso17": lambda d: geom.preprocess_iso17(str(d)),
    "cli.preprocess geom": lambda d: preprocess.main(
        ["geom", "--base_path", str(d), "--dataset", "qm9", "--out_dir",
         str(d / "out")]),
    "CovMatEvaluator(use_force_field=True)":
        lambda d: covmat.CovMatEvaluator(use_force_field=True),
    "cli.smiles_generation": lambda d: smiles_generation.main(
        ["x.pt", "--smiles", "CO", "--out_sdf", str(d / "x.sdf")]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_rdkit_entry_points_raise_naming_rdkit(name, tmp_path):
    _no("rdkit")
    with pytest.raises(ImportError, match="RDKit"):
        ENTRY_POINTS[name](tmp_path)
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("entry", ["PropertyCalculator", "cli.eval_prop"])
def test_psi4_entry_points_raise_naming_psikit(entry, samples):
    _no("psikit")
    with pytest.raises(ImportError, match="psikit"):
        if entry == "PropertyCalculator":
            properties.PropertyCalculator()
        else:
            eval_prop.main([samples])


# ---- true RDKit round trips (where RDKit is installed) ---------------------------

def test_rdkit_smiles_round_trip_matches_jax():
    pytest.importorskip("rdkit")
    for smiles in ("CCO", "c1ccccc1O", "CC(=O)NC(C)C(=O)NC"):
        got = rdkit_bridge.smiles_to_molecule(smiles, seed=3)
        want = jax_bridge.smiles_to_molecule(smiles, seed=3)
        assert_same([got], [want])
        back = rdkit_bridge.rdmol_to_molecule(
            rdkit_bridge.molecule_to_rdmol(got), smiles=smiles)
        assert_same([back], [got])
        assert rdkit_bridge.smiles_to_canonical(smiles) == \
            jax_bridge.smiles_to_canonical(smiles)
        assert rdkit_bridge.mol_to_smiles(rdkit_bridge.molecule_to_rdmol(
            got)) == jax_bridge.mol_to_smiles(jax_bridge.molecule_to_rdmol(
                want))
        np.testing.assert_array_equal(
            rdkit_bridge.mmff_optimize_positions(got, got.pos),
            jax_bridge.mmff_optimize_positions(want, want.pos))


def test_rdkit_sdf_reads_back(tmp_path):
    pytest.importorskip("rdkit")
    from rdkit import Chem

    mol = rdkit_bridge.smiles_to_molecule("CC(=O)O", seed=1)
    confs = mol.pos[None] + np.random.default_rng(0).normal(
        0, 0.1, (3, mol.num_nodes, 3)).astype(np.float32)
    rdkit_bridge.write_sdf(str(tmp_path / "x.sdf"), mol, confs)
    back = [m for m in Chem.SDMolSupplier(str(tmp_path / "x.sdf"),
                                          removeHs=False)]
    assert len(back) == 3
    for m, c in zip(back, confs):
        np.testing.assert_allclose(m.GetConformer(0).GetPositions(), c,
                                   atol=1e-4)
    img = rdkit_bridge.draw_mol_image(back[0], tensor=True)
    assert isinstance(img, torch.Tensor) and img.shape[0] in (3, 4)


def test_rdkit_best_rmsd_matches_chem_rmsd():
    pytest.importorskip("rdkit")
    from agdiff_torch.chem.rmsd import best_rmsd

    mol = rdkit_bridge.smiles_to_molecule("CC(C)(C)O", seed=2)
    gen = mol.pos + np.random.default_rng(1).normal(
        0, 0.2, mol.pos.shape).astype(np.float32)
    want = rdkit_bridge.rdkit_best_rmsd(rdkit_bridge.molecule_to_rdmol(mol),
                                        rdkit_bridge.molecule_to_rdmol(
                                            mol, gen))
    assert abs(best_rmsd(mol, mol.pos, gen) - want) < 1e-4
