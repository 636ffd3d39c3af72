"""The port's synthetic molecules (agdiff_torch/data/synthetic.py) against
the JAX package's generator, and the port's JSON fixtures against the
port's generator. The JAX generator relaxes ring and torsion geometry
through a native kernel when one builds (equal to its numpy body to
~1e-6); the port has the numpy body only, so the comparison runs JAX's
generator on its numpy body, where the two give the same bits."""

import numpy as np
import pytest

import agdiff_tpu.data.native_relax as native_relax
from agdiff_tpu.data import synthetic as jax_synthetic

from agdiff_torch.data import synthetic
from agdiff_torch.data.fixture import load_fixture

FIELDS = ("atom_type", "pos", "bond_index", "bond_type", "pos_ref")


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
        assert a.smiles == b.smiles
        assert a.meta == b.meta


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(rigid=True),
    dict(multiref=True),
    dict(chem="rich"),
    dict(chem="rich", multiref=True),
    dict(min_heavy=12, max_heavy=16),
])
def test_synthetic_dataset_matches_jax(monkeypatch, seed, kw):
    monkeypatch.setattr(native_relax, "get_lib", lambda: None)
    args = dict(num_conformers=2, **kw)
    _assert_same(synthetic.synthetic_dataset(3, seed=seed, **args),
                 jax_synthetic.synthetic_dataset(3, seed=seed, **args))


def test_expand_conformers_and_refusals_match_jax(monkeypatch):
    monkeypatch.setattr(native_relax, "get_lib", lambda: None)
    mols = synthetic.synthetic_dataset(2, seed=1, chem="rich")
    jmols = jax_synthetic.synthetic_dataset(2, seed=1, chem="rich")
    _assert_same(synthetic.expand_conformers(mols, 3, seed=2, jitter=0.05),
                 jax_synthetic.expand_conformers(jmols, 3, seed=2,
                                                 jitter=0.05))
    for kw in (dict(chem="smiles"), dict(chem="rich", rigid=True)):
        with pytest.raises(ValueError):
            synthetic.synthetic_dataset(1, **kw)


@pytest.mark.parametrize("h", [1, 3, 4, 9, 20, 28])
def test_heavy_range_matches_jax(h):
    assert synthetic.heavy_range(h) == jax_synthetic.heavy_range(h)
    lo, hi = synthetic.heavy_range(h)
    assert 4 <= lo <= hi


def test_fixtures_are_the_ports_own_output():
    """data/fixture.py names the arguments of each fixture."""
    _assert_same(load_fixture(),
                 synthetic.synthetic_dataset(4, seed=7, num_conformers=2))
    drugs = [m for h in (20, 28) for m in synthetic.synthetic_dataset(
        2, seed=7, min_heavy=h, max_heavy=h, num_conformers=2)]
    _assert_same(load_fixture("drugs_synthetic"), drugs)
    assert [m.num_nodes for m in drugs] == [50, 56, 69, 73]
