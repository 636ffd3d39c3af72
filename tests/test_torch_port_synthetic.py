"""The port's synthetic molecules (agdiff_torch/data/synthetic.py) against
the JAX package's generator, and the port's JSON fixtures against the
port's generator. Both relax ring and torsion geometry through the same
native kernel (native/relax.cpp) by default, and then give the same bits;
each case also runs with both on their numpy body (JAX's native library
hidden, the port's `_relax` called with use_native=False), which agree to
~1e-6 with the kernel and give the same bits as each other."""

import numpy as np
import pytest

import agdiff_tpu.data.native_relax as native_relax
from agdiff_tpu.data import synthetic as jax_synthetic

from agdiff_torch.data import synthetic
from agdiff_torch.data.fixture import load_fixture

from test_torch_port_native_relax import (  # noqa: F401 (fixtures)
    jax_relax,
    jax_relax_library,
)

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


@pytest.fixture(params=["native", "numpy"])
def relax(request, monkeypatch):
    """Which relaxation both generators run: their defaults (the native
    kernel; JAX's library built privately, test_torch_port_native_relax.py
    jax_relax) or their numpy bodies."""
    if request.param == "native":
        request.getfixturevalue("jax_relax")
    else:
        monkeypatch.setattr(native_relax, "get_lib", lambda: None)
        numpy_relax = synthetic._relax
        monkeypatch.setattr(synthetic, "_relax", lambda *a, **k: numpy_relax(
            *a, **{**k, "use_native": False}))
    return request.param


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(rigid=True),
    dict(multiref=True),
    dict(chem="rich"),
    dict(chem="rich", multiref=True),
    dict(min_heavy=12, max_heavy=16),
])
def test_synthetic_dataset_matches_jax(relax, seed, kw):
    args = dict(num_conformers=2, **kw)
    _assert_same(synthetic.synthetic_dataset(3, seed=seed, **args),
                 jax_synthetic.synthetic_dataset(3, seed=seed, **args))


def test_expand_conformers_and_refusals_match_jax(relax):
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
