"""COV/MAT in the port (chem/rmsd.py, chem/native_rmsd.py,
eval/covmat.py, eval/covmat_linear.py, cli/eval_covmat.py) against the
JAX package's on one samples file: float64 numpy and the same C++ source
on both sides, so results agree to 1e-12; the RMSD primitives on the
cases of tests/test_native_rmsd.py; the native path raising where the
JAX package falls back to numpy."""

import importlib.util
import os
import shutil

import numpy as np
import pytest

from agdiff_tpu.chem import native_rmsd as jax_native
from agdiff_tpu.chem import rmsd as jax_rmsd
from agdiff_tpu.chem.constants import BondType
from agdiff_tpu.chem.mol import Molecule as JaxMolecule
from agdiff_tpu.cli import eval_covmat as jax_cli
from agdiff_tpu.data.synthetic import synthetic_dataset
from agdiff_tpu.eval import covmat as jax_covmat
from agdiff_tpu.eval import covmat_linear as jax_linear
from agdiff_tpu.eval.generate import (
    _save_all as jax_save_all,
    load_samples as jax_load_samples,
)

from agdiff_torch.chem import native_rmsd, rmsd
from agdiff_torch.cli import eval_covmat as cli
from agdiff_torch.eval import covmat, covmat_linear
from agdiff_torch.eval.generate import load_samples

from test_torch_port_common import port_molecule

TOL = 1e-12
FIELDS = ("CoverageR", "MatchingR", "CoverageP", "MatchingP", "thresholds")


def _neopentane_core():
    """Five carbons, one bonded to the other four: 24 automorphisms of
    its heavy-atom graph, so a relabelled conformer scores ~0 only with
    them."""
    s = int(BondType.SINGLE)
    t = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]) * 0.9
    pos = np.concatenate([np.zeros((1, 3)), t]).astype(np.float32)
    i = [0, 0, 0, 0, 1, 2, 3, 4]
    j = [1, 2, 3, 4, 0, 0, 0, 0]
    return JaxMolecule(atom_type=[6] * 5, pos=pos, bond_index=[i, j],
                       bond_type=[s] * 8, smiles="CC(C)(C)C")


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """A samples_all.npz of five molecules with perturbed conformers: two
    or three references each, 2x + 1 generated ones (the symmetric core's
    include relabelled copies of its references), one molecule short of
    the ratio (filtered out) and one with a disconnected SMILES."""
    rng = np.random.default_rng(0)
    mols = synthetic_dataset(3, seed=5, min_heavy=4, max_heavy=6,
                             num_conformers=3) + [_neopentane_core()] * 2
    out = []
    for k, m in enumerate(mols):
        n = m.num_nodes
        refs = m.pos[None] + rng.normal(0, 0.2, (2 if k >= 3 else 3, n, 3))
        num_gen = 2 * len(refs) + (1 if k != 2 else -1)
        gens = refs[rng.integers(0, len(refs), num_gen)] \
            + rng.normal(0, 0.25, (num_gen, n, 3))
        if k >= 3:
            gens[0] = refs[0][[0, 3, 1, 4, 2]]
        smiles = "C.C" if k == 4 else m.smiles
        out.append(JaxMolecule(
            atom_type=m.atom_type, pos=m.pos, bond_index=m.bond_index,
            bond_type=m.bond_type, pos_ref=refs.reshape(-1, 3),
            smiles=smiles, meta={"pos_gen": gens.astype(np.float32)}))
    path = tmp_path_factory.mktemp("covmat") / "samples_all.npz"
    jax_save_all(str(path), out)
    return str(path)


def _same(got, ref, fields=FIELDS):
    for name in fields:
        g, r = np.asarray(getattr(got, name)), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def jax_results(samples):
    return jax_covmat.CovMatEvaluator(num_workers=1, print_fn=lambda *a: None)(
        jax_load_samples(samples))


@pytest.mark.parametrize("use_native,workers", [(False, 1), (True, 1),
                                                (True, 2)])
def test_evaluator_matches_jax(samples, jax_results, use_native, workers):
    """COV-R/P and MAT-R/P of the port's evaluator, numpy or native, in
    one process or over the spawn pool, equal the JAX evaluator's; the
    short and the disconnected molecule are filtered out."""
    lines = []
    got = covmat.CovMatEvaluator(num_workers=workers, use_native=use_native,
                                 print_fn=lines.append)(load_samples(samples))
    _same(got, jax_results)
    assert got.CoverageR.shape == (3, 60)
    want = "native" if use_native else "numpy"
    assert lines == [f"Filtered: 3 / 5 (RMSD: {want})"]
    if workers == 1:
        assert rmsd.last_path == want


@pytest.mark.parametrize("use_native", [False, True])
def test_linear_evaluator_matches_jax(samples, use_native):
    """Per-molecule outputs too: SMILES, least RMSD, top-n mean and each
    confusion matrix, with max_num_gen cut after the ratio cut."""
    kw = dict(top_n=2, max_num_gen=5, print_fn=lambda *a: None)
    ref = jax_linear.LinearCovMatEvaluator(**kw)(jax_load_samples(samples))
    got = covmat_linear.LinearCovMatEvaluator(use_native=use_native, **kw)(
        load_samples(samples))
    _same(got, ref, FIELDS + ("min_rmsd", "avg_best_n_rmsd"))
    assert got.smiles == ref.smiles
    assert len(got.confusion_matrices) == len(ref.confusion_matrices) == 3
    for g, r in zip(got.confusion_matrices, ref.confusion_matrices):
        assert g.shape == r.shape and g.shape[1] <= 5
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL)
    # the symmetric core's relabelled copy matches only through its
    # automorphisms
    assert got.min_rmsd[-1] < 1e-6


def test_rmsd_primitives_match_jax():
    """kabsch_rmsd, graph_automorphisms (numpy and native) and best_rmsd
    on tests/test_native_rmsd.py's cases."""
    for seed in range(5):
        jm = synthetic_dataset(1, seed=seed, min_heavy=4, max_heavy=7)[0]
        heavy = jm.heavy_atom_subset()
        m = port_molecule(jm)
        ph = m.heavy_atom_subset()
        np.testing.assert_array_equal(ph.atom_type, heavy.atom_type)
        np.testing.assert_array_equal(ph.bond_adjacency(),
                                      heavy.bond_adjacency())
        want = {tuple(p) for p in jax_rmsd.graph_automorphisms(
            heavy.atom_type, heavy.bond_adjacency())}
        assert want == {tuple(p) for p in rmsd.graph_automorphisms(
            ph.atom_type, ph.bond_adjacency())}
        assert want == {tuple(p) for p in native_rmsd.enumerate_automorphisms(
            ph.atom_type, ph.bond_adjacency())}
    rng = np.random.default_rng(0)
    jm = synthetic_dataset(1, seed=3, min_heavy=5, max_heavy=6)[0]
    m, n = port_molecule(jm), jm.num_nodes
    refs = jm.pos[None] + rng.normal(scale=0.2, size=(3, n, 3))
    gens = jm.pos[None] + rng.normal(scale=0.3, size=(5, n, 3))
    golden = jax_rmsd.rmsd_confusion_matrix(jm, refs, gens, use_native=False)
    for use_native in (False, True):
        np.testing.assert_allclose(rmsd.rmsd_confusion_matrix(
            m, refs, gens, use_native=use_native), golden, rtol=0, atol=TOL)
    for r, g in ((refs[0], gens[1]), (refs[2], gens[4])):
        assert abs(rmsd.kabsch_rmsd(r, g) - jax_rmsd.kabsch_rmsd(r, g)) \
            <= TOL
        assert abs(rmsd.best_rmsd(m, r, g) - jax_rmsd.best_rmsd(jm, r, g)) \
            <= TOL
        assert abs(native_rmsd.best_rmsd(m, r, g)
                   - jax_native.best_rmsd(jm, r, g)) <= TOL
    s = int(BondType.SINGLE)   # the symmetry case: a permuted CF2 fragment
    tri = port_molecule(JaxMolecule(
        atom_type=[6, 9, 9], pos=[[0, 0, 0], [1.4, 0, 0], [0, 2.2, 0]],
        bond_index=[[0, 1, 0, 2], [1, 0, 2, 0]], bond_type=[s] * 4))
    ref = np.array(tri.pos, float)
    assert rmsd.best_rmsd(tri, ref, ref[[0, 2, 1]]) < 1e-7
    assert native_rmsd.best_rmsd(tri, ref, ref[[0, 2, 1]]) < 1e-7


def test_cli_writes_what_jax_cli_writes(samples, tmp_path):
    """`python -m agdiff_torch.cli.eval_covmat` and the JAX package's CLI
    on copies of one samples file: the same arrays in <samples>_covmat.npz
    and the same table in the .csv."""
    out = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "samples_all.npz")
        shutil.copy(samples, path)
        main([path, "--num_workers", "1"])
        out[name] = d
    with np.load(out["port"] / "samples_all_covmat.npz") as got, \
            np.load(out["jax"] / "samples_all_covmat.npz") as ref:
        assert sorted(got.files) == sorted(ref.files) == sorted(FIELDS)
        for k in FIELDS:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL)
    assert (out["port"] / "samples_all_covmat.csv").read_text() == \
        (out["jax"] / "samples_all_covmat.csv").read_text()


def test_native_path_raises_instead_of_falling_back(samples, tmp_path,
                                                    monkeypatch):
    """An unbuildable source: use_native=True raises (the JAX package
    would quietly run numpy); use_native=False still scores; the force
    field, which needs RDKit, is refused when constructed, naming RDKit,
    where RDKit is missing."""
    bad = tmp_path / "rmsd.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_rmsd, "SOURCE", str(bad))
    monkeypatch.setattr(native_rmsd, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_rmsd, "_lib", None)
    mol = load_samples(samples)[0]
    n = mol.num_nodes
    refs, gens = mol.pos_ref.reshape(-1, n, 3), mol.meta["pos_gen"]
    with pytest.raises(RuntimeError, match="cannot build"):
        rmsd.rmsd_confusion_matrix(mol, refs, gens)
    with pytest.raises(RuntimeError):
        covmat.CovMatEvaluator(num_workers=1)(load_samples(samples))
    assert rmsd.rmsd_confusion_matrix(mol, refs, gens,
                                      use_native=False).shape == (3, 7)
    assert os.listdir(tmp_path / "build") == []
    if importlib.util.find_spec("rdkit") is None:
        with pytest.raises(ImportError, match="RDKit"):
            covmat.CovMatEvaluator(use_force_field=True)
