"""The port's data, graph and geometry ops against the JAX package's, on
the same numpy inputs (exact, or 1e-6)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.config import load_config as jax_load_config
from agdiff_tpu.data import bucketing as jbucket
from agdiff_tpu.data.synthetic import synthetic_dataset
from agdiff_tpu.data.transforms import extend_bond_order as jax_extend
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.ops import geometry as jgeo
from agdiff_tpu.ops.graph import radius_union_mask as jax_radius
from agdiff_tpu.ops.pairs import triu_pairs as jax_triu

from agdiff_torch.chem.mol import Molecule
from agdiff_torch.config import ModelConfig, load_config
from agdiff_torch.data import bucketing
from agdiff_torch.data.fixture import load_fixture
from agdiff_torch.data.transforms import extend_bond_order
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.ops import geometry
from agdiff_torch.ops.graph import radius_union_mask
from agdiff_torch.ops.pairs import triu_pairs

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_mol(m):
    return Molecule(atom_type=m.atom_type, pos=m.pos, bond_index=m.bond_index,
                    bond_type=m.bond_type, pos_ref=m.pos_ref,
                    smiles=m.smiles)


@pytest.fixture(scope="module")
def mols():
    return synthetic_dataset(3, seed=5, min_heavy=3, max_heavy=6)


@pytest.fixture(scope="module")
def geom():
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(3, 9, 3)).astype(np.float32) * 2.0
    node_mask = np.ones((3, 9), bool)
    node_mask[1, 7:] = False
    node_mask[2, 5:] = False
    adj = rng.integers(0, 4, size=(3, 9, 9))
    adj = np.triu(adj, 1)
    adj = (adj + np.transpose(adj, (0, 2, 1))).astype(np.int32)
    return pos, node_mask, adj


def test_extend_bond_order_matches_jax(mols):
    for m in mols:
        raw = m.bond_adjacency()
        for order in (1, 2, 3):
            np.testing.assert_array_equal(extend_bond_order(raw, order),
                                          jax_extend(raw, order))


def test_pad_molecules_matches_jax(mols):
    ref = jbucket.pad_molecules(mols, 24, batch_size=4)
    got = bucketing.pad_molecules([_port_mol(m) for m in mols], 24,
                                  batch_size=4)
    for name in ("atom_type", "pos", "node_mask", "bond_adj", "graph_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert bucketing.pick_bucket(20, (32, 64)) == 32
    with pytest.raises(ValueError):
        bucketing.pick_bucket(70, (32, 64))
    rep = bucketing.repeat_molecule(_port_mol(mols[0]), 3, 24)
    jrep = jbucket.repeat_molecule(mols[0], 3, 24)
    np.testing.assert_array_equal(rep.bond_adj.numpy(),
                                  np.asarray(jrep.bond_adj))


def test_geometry_matches_jax(geom):
    pos, node_mask, adj = geom
    tpos, tmask = torch.from_numpy(pos), torch.from_numpy(node_mask)
    d = geometry.pairwise_distance(tpos)
    jd = jgeo.pairwise_distance(jnp.asarray(pos))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)

    em, et, lm = radius_union_mask(d, torch.from_numpy(adj).long(), tmask,
                                   3.0)
    jem, jet, jlm = jax_radius(jd, jnp.asarray(adj), jnp.asarray(node_mask),
                               3.0)
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(et.numpy(), np.asarray(jet))
    np.testing.assert_array_equal(lm.numpy(), np.asarray(jlm))

    score = np.random.default_rng(3).normal(size=d.shape).astype(np.float32)
    eq = geometry.eq_transform_dense(torch.from_numpy(score), tpos, em, d)
    jeq = jgeo.eq_transform_dense(jnp.asarray(score), jnp.asarray(pos), jem,
                                  jd)
    np.testing.assert_allclose(eq.numpy(), np.asarray(jeq), atol=1e-6)

    c = geometry.center_pos(tpos, tmask)
    jc = jgeo.center_pos(jnp.asarray(pos), jnp.asarray(node_mask))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)

    vec = pos * 3.0
    vec[0, 0] = 0.0
    for limit in (0.5, 4.0):
        np.testing.assert_allclose(
            geometry.clip_norm(torch.from_numpy(vec), limit).numpy(),
            np.asarray(jgeo.clip_norm(jnp.asarray(vec), limit)), atol=1e-6)


@pytest.mark.parametrize("n", [2, 7, 32])
def test_triu_pairs_match_jax(n):
    got, ref = triu_pairs(n), jax_triu(n)
    np.testing.assert_array_equal(got.iu.numpy(), np.asarray(ref.iu))
    np.testing.assert_array_equal(got.ju.numpy(), np.asarray(ref.ju))
    np.testing.assert_array_equal(got.pair_id.numpy(),
                                  np.asarray(ref.pair_id))
    # incidence lists: node n's pairs, increasing, with the other endpoint
    ptr = got.inc_ptr.numpy()
    iu, ju = got.iu.numpy(), got.ju.numpy()
    for node in range(n):
        pairs = got.inc_pair.numpy()[ptr[node]:ptr[node + 1]]
        other = got.inc_other.numpy()[ptr[node]:ptr[node + 1]]
        want = np.nonzero((iu == node) | (ju == node))[0]
        np.testing.assert_array_equal(pairs, want)
        np.testing.assert_array_equal(other, np.where(iu[want] == node,
                                                      ju[want], iu[want]))


def test_schedules_match_jax():
    for schedule in ("sigmoid", "linear", "quad"):
        cfg = ModelConfig(beta_schedule=schedule)
        got, ref = make_diffusion(cfg), jax_diffusion(cfg)
        np.testing.assert_array_equal(got.betas, ref.betas)
        np.testing.assert_array_equal(got.alphas, ref.alphas)
        np.testing.assert_array_equal(got.sigmas, ref.sigmas)


def test_config_reads_the_jax_yaml():
    path = os.path.join(ROOT, "configs", "qm9_fast.yml")
    got, ref = load_config(path), jax_load_config(path)
    for f in dataclasses.fields(got.model):
        assert getattr(got.model, f.name) == getattr(ref.model, f.name), f
    assert got.buckets == tuple(ref.buckets.max_nodes)


def test_fixture_equals_synthetic_dataset():
    got = load_fixture("qm9_synthetic")
    ref = synthetic_dataset(4, seed=7, num_conformers=2)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.num_nodes <= 32
        for name in ("atom_type", "pos", "bond_index", "bond_type",
                     "pos_ref"):
            np.testing.assert_array_equal(getattr(g, name), getattr(r, name))
        assert g.smiles == r.smiles


def test_drugs_fixture_equals_synthetic_dataset():
    got = load_fixture("drugs_synthetic")
    ref = [m for h in (20, 28) for m in synthetic_dataset(
        2, seed=7, min_heavy=h, max_heavy=h, num_conformers=2)]
    assert [g.num_nodes for g in got] == [50, 56, 69, 73]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for name in ("atom_type", "pos", "bond_index", "bond_type",
                     "pos_ref"):
            np.testing.assert_array_equal(getattr(g, name), getattr(r, name))
        assert g.smiles == r.smiles and g.num_ref == 2


@pytest.mark.parametrize("name", ["drugs_fast", "drugs_default"])
def test_config_reads_the_drugs_yaml(name):
    path = os.path.join(ROOT, "configs", f"{name}.yml")
    got, ref = load_config(path), jax_load_config(path)
    for f in dataclasses.fields(got.model):
        assert getattr(got.model, f.name) == getattr(ref.model, f.name), f
    assert got.model.smooth_conv
    assert got.buckets == tuple(ref.buckets.max_nodes)
