"""The protein path of the port against the JAX package's on the CPU:
chem/pdb.py (parse, perceive, write), chem/mol.py's connected components,
data/protein.py (sidechain subgraphs, the dataset, subgraph-decomposed
scores), examples/alanine_dipeptide.py (the z-matrix build and the run
end to end on the CPU, whose 'pksf' takes K1's plain twin there), and the
auxiliary ops of ops/geometry.py, ops/masked.py and data/transforms.py
on tests/test_aux_ops.py's inputs."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.chem import mol as jax_mol
from agdiff_tpu.chem import pdb as jax_pdb
from agdiff_tpu.data import protein as jax_protein
from agdiff_tpu.data import transforms as jax_transforms
from agdiff_tpu.data.bucketing import pad_molecules as jax_pad
from agdiff_tpu.data.synthetic import synthetic_dataset
from agdiff_tpu.ops import geometry as jax_geometry
from agdiff_tpu.ops import masked as jax_masked

from agdiff_torch.chem import mol as port_mol
from agdiff_torch.chem import pdb
from agdiff_torch.data import protein, transforms
from agdiff_torch.examples import alanine_dipeptide as example
from agdiff_torch.models.reference_checkpoint import (
    export_reference_state_dict,
)
from agdiff_torch.ops import geometry, masked

from test_torch_port_common import (
    FAST_XLA,
    SMALL,
    configs,
    jax_variables,
    port_model,
    port_molecule,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import alanine_dipeptide as jax_example  # noqa: E402

# tests/test_protein.py:26-32: residue-ish names for the dipeptide's atoms
NAMES = np.array(["CH3", "H1", "H2", "H3", "C", "O", "N", "H", "CA", "HA",
                  "CB", "HB1", "HB2", "HB3", "C", "O", "N", "H", "CH3", "H1",
                  "H2", "H3"])
RES_IDS = np.array([1] * 6 + [2] * 10 + [3] * 6, np.int32)
RES_NAMES = np.array(["ACE"] * 6 + ["ALA"] * 10 + ["NME"] * 6)
MOL_FIELDS = ("atom_type", "pos", "bond_index", "bond_type")
SCORE_TOL = 2e-4
# a PDB with HETATM, CONECT records, element columns left blank (the atom
# name heuristics) and an unknown element, which the reader drops
CONECT_PDB = """\
HETATM    1  C1  LIG A   1       0.000   0.000   0.000  1.00  0.00
HETATM    2  CL  LIG A   1       1.760   0.000   0.000  1.00  0.00
HETATM    3  O   LIG A   1      -1.200   0.300   0.000  1.00  0.00          O
HETATM    4  XX  LIG A   1       5.000   5.000   5.000  1.00  0.00          Xx
HETATM    5  N1  LIG A   2       0.000   1.400   0.000  1.00  0.00
CONECT    1    2    3
CONECT    1    5
CONECT    5    1
END
"""


def _same_molecule(a, b):
    for f in MOL_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _same_annotations(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _written(write, mol, confs, ann, path):
    write(path, mol, confs, annotations=ann)
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def structures(tmp_path_factory):
    """The dipeptide of each package written with the residue names and
    parsed back (tests/test_protein.py:10-33): {'jax': (mol, ann, text),
    'port': ...}."""
    root = tmp_path_factory.mktemp("pdb")
    ann = {"atom_name": NAMES, "res_name": RES_NAMES, "res_id": RES_IDS}
    out = {}
    for key, build, mod in (("jax", jax_example.build_alanine_dipeptide,
                             jax_pdb),
                            ("port", example.build_alanine_dipeptide, pdb)):
        m = build()
        text = _written(mod.write_pdb, m, m.pos, ann, str(root / key))
        out[key] = mod.parse_pdb(text) + (text,)
    return out


def test_build_alanine_dipeptide_equals_jax():
    """The z-matrix build gives the JAX example's molecule bit for bit, at
    the default torsions and at others."""
    for phi, psi in ((-80.0, -60.0), (60.0, 150.0)):
        a = jax_example.build_alanine_dipeptide(phi, psi)
        b = example.build_alanine_dipeptide(phi, psi)
        _same_molecule(a, b)
        assert a.smiles == b.smiles and b.num_nodes == 22


def test_pdb_round_trip_equals_jax(structures):
    """write_pdb's text and parse_pdb's Molecule and annotations equal
    JAX's; the 7 backbone atoms and the one alpha carbon of
    tests/test_protein.py:41-46."""
    jm, jann, jtext = structures["jax"]
    pm, pann, ptext = structures["port"]
    assert ptext == jtext
    _same_molecule(jm, pm)
    _same_annotations(jann, pann)
    assert pm.num_nodes == 22
    assert (pann["res_id"] == RES_IDS).all()
    assert pann["is_backbone"].sum() == 7 and pann["is_alpha"].sum() == 1


def test_multi_model_pdb_equals_jax(tmp_path):
    """Several conformations: one MODEL/ENDMDL block each, without
    annotations (element names, UNK 1), the text JAX's."""
    m = example.build_alanine_dipeptide()
    confs = m.pos[None] + np.arange(3, dtype=np.float32)[:, None, None]
    jtext = _written(jax_pdb.write_pdb, m, confs, None, str(tmp_path / "j"))
    ptext = _written(pdb.write_pdb, m, confs, None, str(tmp_path / "p"))
    assert ptext == jtext and ptext.count("MODEL ") == 3
    mol, _ = pdb.parse_pdb(ptext)
    assert mol.num_nodes == 3 * 22


def test_conect_and_element_heuristics_equal_jax():
    """CONECT bonds (not perceived ones), elements from the atom name
    when the element columns are blank, an unknown element dropped."""
    jm, jann = jax_pdb.parse_pdb(CONECT_PDB)
    pm, pann = pdb.parse_pdb(CONECT_PDB)
    _same_molecule(jm, pm)
    _same_annotations(jann, pann)
    assert pm.atom_type.tolist() == [6, 17, 8, 7]
    assert pm.bond_index.shape == (2, 6)


def test_perceive_bonds_equals_jax(structures):
    """perceive_bonds on the dipeptide and on synthetic molecules (their
    every element), at the default and a tight tolerance."""
    mols = [structures["port"][0]] + synthetic_dataset(
        4, seed=3, min_heavy=5, max_heavy=8, chem="rich")
    for m in mols:
        for tol in (0.45, 0.1):
            want = jax_pdb.perceive_bonds(m.atom_type, m.pos, tol)
            assert pdb.perceive_bonds(m.atom_type, m.pos, tol) == want


def test_connected_components_equal_jax():
    """connected_components and split_disconnected on a molecule of two
    synthetic molecules side by side (agdiff_tpu/chem/mol.py:158-204)."""
    a, b = synthetic_dataset(2, seed=4, min_heavy=3, max_heavy=5)
    n = a.num_nodes
    joined = jax_mol.Molecule(
        atom_type=np.concatenate([a.atom_type, b.atom_type]),
        pos=np.concatenate([a.pos, b.pos + 10.0]),
        bond_index=np.concatenate([a.bond_index, b.bond_index + n], 1),
        bond_type=np.concatenate([a.bond_type, b.bond_type]),
        smiles=f"{a.smiles}.{b.smiles}")
    port = port_molecule(joined)
    want = jax_mol.connected_components(joined)
    got = port_mol.connected_components(port)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.max() == 1
    pieces = port_mol.split_disconnected(port)
    for j, p in zip(jax_mol.split_disconnected(joined), pieces, strict=True):
        _same_molecule(j, p)
        assert j.meta == p.meta and p.smiles is None


def test_subgraphs_equal_jax_bit_for_bit(structures):
    """sample_sidechain_subgraph from the same numpy seed (drawn centres,
    given centres, a cutoff too small to hold 4 atoms) and the dataset's
    draws and collate (tests/test_protein.py:49-72): the same
    Molecules and meta."""
    jm, jann, _ = structures["jax"]
    pm, pann, _ = structures["port"]
    for kw in (dict(cutoff=3.0), dict(cutoff=6.0), dict(cutoff=0.5),
               dict(cutoff=3.0, center_idx=8)):
        for seed in (0, 1, 2):
            j = jax_protein.sample_sidechain_subgraph(
                jm, jann, rng=np.random.default_rng(seed), **kw)
            p = protein.sample_sidechain_subgraph(
                pm, pann, rng=np.random.default_rng(seed), **kw)
            assert (j is None) == (p is None)
            if p is None:
                continue
            _same_molecule(j, p)
            assert j.meta.keys() == p.meta.keys()
            for k in j.meta:
                assert np.array_equal(j.meta[k], p.meta[k]), k
            assert p.bond_index.max() < p.num_nodes
            for r in np.unique(p.meta["res_id"]):
                assert (p.meta["res_id"] == r).sum() == (RES_IDS == r).sum()
    jds = jax_protein.SidechainConformationDataset([(jm, jann)], cutoff=3.0,
                                                   seed=1)
    pds = protein.SidechainConformationDataset([(pm, pann)], cutoff=3.0,
                                               seed=1)
    jitems = [jds[0] for _ in range(4)] + [None]
    pitems = [pds[0] for _ in range(4)] + [None]
    assert len(pds) == 1 and len(pds.collate(pitems)) == 4
    for j, p in zip(jds.collate(jitems), pds.collate(pitems), strict=True):
        _same_molecule(j, p)


def test_subgraph_scores_equal_jax_with_a_fake_score(structures):
    """subgraph_position_scores with the constant score of
    tests/test_protein.py:74-87, at cutoffs 3 and 6 A: JAX's scores bit
    for bit, every atom covered."""
    jm, jann, _ = structures["jax"]
    pm, pann, _ = structures["port"]

    def ones(batch):
        return np.ones(batch.pos.shape, np.float32)

    for cutoff in (3.0, 6.0):
        want = jax_protein.subgraph_position_scores(jm, jann, ones, 32,
                                                    cutoff=cutoff)
        got = protein.subgraph_position_scores(
            pm, pann, lambda b: torch.ones(b.pos.shape), 32, cutoff=cutoff)
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert (got == 1.0).all()


def _scores(out, pos, geom):
    """The global and local position scores of a model output at pos."""
    return (geom.eq_transform_dense(out.edge_inv_global, pos, out.edge_mask,
                                    out.edge_length)
            + geom.eq_transform_dense(out.edge_inv_local, pos,
                                      out.local_mask, out.edge_length))


def test_subgraph_scores_with_the_dense_model_equal_jax(structures):
    """subgraph_position_scores with the small dense model's position
    scores as score_fn (cutoff 3 A, max_nodes 32: several subgraphs,
    overlapping ones averaged), to 2e-4 of the largest score."""
    jm, jann, _ = structures["jax"]
    pm, pann, _ = structures["port"]
    jcfg, cfg = configs()
    jb = jax_pad([jm], 32, batch_size=1)
    jmodel, variables = jax_variables(jcfg, jb)
    model = port_model(cfg, variables)
    compiled = []

    def jax_score(batch):
        def fn(v, b):
            return _scores(jmodel.apply(v, b, train=False), b.pos,
                           jax_geometry)
        if not compiled:
            compiled.append(jax.jit(fn).lower(variables, batch).compile(
                compiler_options=FAST_XLA))
        return compiled[0](variables, batch)

    def port_score(batch):
        with torch.no_grad():
            return _scores(model(batch), batch.pos, geometry)

    want = jax_protein.subgraph_position_scores(jm, jann, jax_score, 32,
                                                cutoff=3.0)
    got = protein.subgraph_position_scores(pm, pann, port_score, 32,
                                           cutoff=3.0)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= SCORE_TOL * np.abs(want).max()


def test_example_runs_end_to_end_on_the_cpu(structures, tmp_path,
                                           monkeypatch):
    """python -m agdiff_torch.examples.alanine_dipeptide on a bf16
    reference .pt with --device cpu at 2 samples x 4 steps: the runner
    takes 'pksf' at bucket 32, the samples are finite, samples.pdb holds
    two models of the dipeptide, samples.npz the samples and their
    heavy-atom RMSDs; --build-only writes input.pdb alone, the JAX
    example's text."""
    from agdiff_torch.config import ModelConfig
    from agdiff_torch.eval.generate import GenerationRunner

    jcfg, _ = configs()
    jb = jax_pad([structures["jax"][0]], 32, batch_size=1)
    _, variables = jax_variables(jcfg, jb)
    bf16 = dict(SMALL, dtype="bfloat16")
    ckpt = str(tmp_path / "model.pt")
    torch.save({"model": export_reference_state_dict(
        port_model(ModelConfig(**bf16), variables)),
        "config": {"model": bf16}}, ckpt)
    engines = []
    real = GenerationRunner.forward

    def spy(self, engine):
        engines.append(engine)
        return real(self, engine)
    monkeypatch.setattr(GenerationRunner, "forward", spy)
    out = str(tmp_path / "out")
    pos_gen, rmsd = example.main([ckpt, "--num_samples", "2", "--n_steps",
                                  "4", "--out", out, "--device", "cpu"])
    assert set(engines) == {"pksf"}
    assert pos_gen.shape == (2, 22, 3) and np.isfinite(pos_gen).all()
    with open(os.path.join(out, "samples.pdb")) as f:
        text = f.read()
    assert text.count("MODEL ") == 2
    assert pdb.parse_pdb(text)[0].num_nodes == 2 * 22
    saved = np.load(os.path.join(out, "samples.npz"))
    assert np.array_equal(saved["pos_gen"], pos_gen)
    assert np.array_equal(saved["rmsd"], rmsd) and np.isfinite(rmsd).all()
    jout, pout = str(tmp_path / "jax_only"), str(tmp_path / "port_only")
    jax_example.main(["--build-only", "--out", jout])
    assert example.main(["--build-only", "--out", pout]) is None
    assert os.listdir(pout) == ["input.pdb"]
    with open(os.path.join(jout, "input.pdb")) as f, \
            open(os.path.join(pout, "input.pdb")) as g:
        assert f.read() == g.read()


# ---- the auxiliary ops (tests/test_aux_ops.py's inputs) ---------------------


@pytest.mark.parametrize("kind,pos,index", [
    ("angle", [[1.0, 0, 0], [0, 0, 0], [0, 1.0, 0]], [[0], [1], [2]]),
    ("angle", [[1.0, 0, 0], [0, 0, 0], [-1.0, 0, 0]], [[0], [1], [2]]),
    ("dihedral", [[1.0, 0, 0], [0, 0, 0], [0, 0, 1.0], [0, 1.0, 1.0]],
     [[0], [1], [2], [3]]),
])
def test_internal_coordinates_equal_jax(kind, pos, index):
    """get_angle and get_dihedral (test_aux_ops.py:22-41): JAX's values to
    f32 rounding, and the right angle, the straight one and 90
    degrees."""
    jfn = getattr(jax_geometry, f"get_{kind}")
    fn = getattr(geometry, f"get_{kind}")
    want = np.asarray(jfn(jnp.asarray(pos), jnp.asarray(index)))
    got = fn(torch.tensor(pos), torch.tensor(index)).numpy()
    assert got.shape == want.shape == (1, 1)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[0, 0], {"angle": np.pi / 2 if pos[2][1]
                                           else np.pi,
                                           "dihedral": np.pi / 2}[kind],
                               atol=1e-5)


def test_angle_dihedral_transform_equals_jax():
    """add_angle_dihedral's index lists (test_aux_ops.py:95-111) and the
    angles and dihedrals they give, on two synthetic molecules."""
    for seed in (3, 5):
        jm = synthetic_dataset(1, seed=seed, min_heavy=4, max_heavy=6)[0]
        pm = port_molecule(jm)
        jax_transforms.add_angle_dihedral(jm)
        transforms.add_angle_dihedral(pm)
        for key, fn in (("angle_index", "get_angle"),
                        ("dihedral_index", "get_dihedral")):
            assert np.array_equal(jm.meta[key], pm.meta[key])
            assert pm.meta[key].shape[1] > 0
            want = np.asarray(getattr(jax_geometry, fn)(
                jnp.asarray(jm.pos), jnp.asarray(jm.meta[key])))
            got = getattr(geometry, fn)(torch.from_numpy(pm.pos),
                                        torch.from_numpy(
                                            pm.meta[key]).long()).numpy()
            np.testing.assert_allclose(got, want, atol=2e-6)


def test_readouts_and_coarse_graining_equal_jax(rng):
    """mean_readout, sum_readout, coarse_grain, complete_graph_mask and
    masked_softmax (test_aux_ops.py:44-88 and random inputs): JAX's
    values to f32 rounding, masks exactly."""
    x = rng.normal(size=(2, 5, 4)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    for name in ("mean_readout", "sum_readout"):
        want = np.asarray(getattr(jax_masked, name)(jnp.asarray(x),
                                                    jnp.asarray(mask)))
        got = getattr(masked, name)(torch.from_numpy(x),
                                    torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pos = rng.normal(size=(2, 4, 3)).astype(np.float32)
    attr = rng.normal(size=(2, 4, 2)).astype(np.float32)
    onehot = np.zeros((2, 4, 3), np.float32)
    onehot[:, :2, 0] = 1
    onehot[:, 2:, 1] = 1     # cluster 2 empty
    cmask = np.array([[1, 1, 1, 1], [1, 0, 1, 1]], bool)
    want = jax_masked.coarse_grain(*map(jnp.asarray, (pos, attr, onehot,
                                                      cmask)))
    got = masked.coarse_grain(*map(torch.from_numpy, (pos, attr, onehot,
                                                      cmask)))
    for w, g in zip(want, got, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert got[2].tolist() == [[True, True, False], [True, True, False]]
    node_mask = np.array([[True, True, True, False]])
    cg = masked.complete_graph_mask(torch.from_numpy(node_mask)).numpy()
    assert np.array_equal(cg, np.asarray(jax_masked.complete_graph_mask(
        jnp.asarray(node_mask))))
    assert cg.sum() == 6 and not cg[0].diagonal().any()
    logits = rng.normal(size=(3, 6)).astype(np.float32) * 4
    smask = rng.random((3, 6)) < 0.6
    smask[2] = False
    for dim in (-1, 0):
        want = np.asarray(jax_masked.masked_softmax(
            jnp.asarray(logits), jnp.asarray(smask), axis=dim))
        got = masked.masked_softmax(torch.from_numpy(logits),
                                    torch.from_numpy(smask), dim=dim).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert (got[~smask] == 0).all()


def test_convert_cluster_score_d_equals_jax(rng):
    """Cluster distance scores to per-node position scores: JAX's
    eq_transform at cluster level, each node its cluster's row."""
    b, k, n = 2, 4, 7
    cpos = rng.normal(size=(b, k, 3)).astype(np.float32)
    score = rng.normal(size=(b, k, k)).astype(np.float32)
    emask = rng.random((b, k, k)) < 0.7
    length = np.linalg.norm(cpos[:, :, None] - cpos[:, None], axis=-1)
    index = rng.integers(0, k, size=(b, n))
    want = np.asarray(jax_geometry.convert_cluster_score_d(
        *map(jnp.asarray, (score, cpos, emask, length, index))))
    got = geometry.convert_cluster_score_d(*map(torch.from_numpy, (
        score, cpos, emask, length.astype(np.float32), index))).numpy()
    assert got.shape == want.shape == (b, n, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_transforms_equal_jax():
    """edges_from_adjacency, center_positions, add_edge_length,
    add_placeholder and add_edge_name (both forms) on synthetic
    molecules: JAX's arrays and labels."""
    for jm in synthetic_dataset(2, seed=6, min_heavy=4, max_heavy=6):
        pm = port_molecule(jm)
        adj = jax_transforms.extend_bond_order(jm.bond_adjacency())
        for w, g in zip(jax_transforms.edges_from_adjacency(adj),
                        transforms.edges_from_adjacency(adj), strict=True):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.array_equal(transforms.center_positions(pm.pos),
                              jax_transforms.center_positions(jm.pos))
        for asymmetric in (True, False):
            jc, pc = port_molecule(jm), port_molecule(jm)
            jax_transforms.add_edge_name(jc, asymmetric)
            transforms.add_edge_name(pc, asymmetric)
            assert pc.meta["edge_name"] == jc.meta["edge_name"]
            assert np.array_equal(pc.meta["edge_length"],
                                  jc.meta["edge_length"])
        jax_transforms.add_placeholder(jm)
        transforms.add_placeholder(pm)
        for key in ("pos_gen", "d_gen", "d_recover"):
            assert np.array_equal(pm.meta[key], jm.meta[key])


def test_symmetric_edge_noise_equals_jax():
    """One draw per undirected bond on both directed copies: from the
    same numpy seed JAX's noise; from a torch generator JAX's function
    fed the same draws."""
    mol = synthetic_dataset(1, seed=2, min_heavy=5, max_heavy=6)[0]
    want = jax_transforms.symmetric_edge_noise(np.random.default_rng(3),
                                               mol.bond_index)
    got = transforms.symmetric_edge_noise(np.random.default_rng(3),
                                          mol.bond_index)
    assert got.shape == (mol.bond_index.shape[1], 1)
    assert got.dtype == want.dtype and np.array_equal(got, want)

    class Injected:
        def normal(self, size):
            return torch.randn(size, generator=torch.Generator().manual_seed(
                4)).numpy()
    want = jax_transforms.symmetric_edge_noise(Injected(), mol.bond_index)
    got = transforms.symmetric_edge_noise(torch.Generator().manual_seed(4),
                                          mol.bond_index)
    assert np.array_equal(got, want)
    i, j = mol.bond_index
    pair = {(a, b): k for k, (a, b) in enumerate(zip(i, j))}
    assert all(got[k] == got[pair[(b, a)]] for (a, b), k in pair.items())
