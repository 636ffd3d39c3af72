"""The port's native relaxation (agdiff_torch/data/native_relax.py, g++ on
native/relax.cpp) against the port's numpy `_relax` and the JAX package's
native kernel (agdiff_tpu/data/native_relax.py) on the problems of
tests/test_native_relax.py: numpy to 1e-6 (its tolerance), JAX's library
bit for bit (the same source built with the same flags on one machine);
two runs equal, the polish constraints met; an unbuildable source
raising where the JAX package returns None.

JAX's library is built by its own loader into a private directory
(`jax_relax`): its loader writes native/build/librelax.so in place, and
test workers building it at once can load a half-written file (ROADMAP.md,
reference-side defects)."""

import os

import numpy as np
import pytest

from agdiff_tpu.data import native_relax as jax_native

from agdiff_torch.data import native_relax
from agdiff_torch.data.synthetic import _relax


def _problem(seed, n=20):
    """tests/test_native_relax.py's problem (a copy: importing that file
    builds JAX's library in native/build/ at collection)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=2.0, size=(n, 3))
    constraints = [(i, i + 1, 1.5) for i in range(n - 1)]
    constraints += [(i, i + 2, 2.4) for i in range(0, n - 2, 3)]
    polish = constraints[: n - 1]
    exclude = np.zeros((n, n), bool)
    for i, j, _ in constraints:
        exclude[i, j] = exclude[j, i] = True
    return pos, constraints, exclude, polish


@pytest.fixture(scope="session")
def jax_relax_library(tmp_path_factory):
    """JAX's library, built by its get_lib into a temporary directory of
    this test run."""
    d = tmp_path_factory.mktemp("jax_relax")
    names = ("_SO", "_BUILD_DIR", "_lib", "_failed")
    saved = {n: getattr(jax_native, n) for n in names}
    jax_native._BUILD_DIR, jax_native._SO = str(d), str(d / "librelax.so")
    jax_native._lib, jax_native._failed = None, False
    try:
        lib = jax_native.get_lib()
    finally:
        for n, v in saved.items():
            setattr(jax_native, n, v)
    assert lib is not None
    return lib


@pytest.fixture
def jax_relax(jax_relax_library, monkeypatch):
    """The JAX package's native relax on its privately built library."""
    monkeypatch.setattr(jax_native, "_lib", jax_relax_library)
    return jax_native


@pytest.mark.parametrize("seed,iters", [(0, 40), (3, 60), (5, 0)])
def test_native_matches_numpy_and_jax(jax_relax, seed, iters):
    pos, constraints, exclude, polish = _problem(seed)
    want = _relax(pos.copy(), constraints, exclude, iters=iters,
                  polish=polish, use_native=False)
    got = native_relax.relax(pos.copy(), constraints, exclude, iters, 0.04,
                             1.5, polish)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(
        _relax(pos.copy(), constraints, exclude, iters=iters, polish=polish),
        got)
    jax_out = jax_relax.relax(pos.copy(), constraints, exclude, iters, 0.04,
                              1.5, polish)
    assert np.array_equal(got, jax_out)


def test_deterministic_and_satisfies_constraints():
    pos, constraints, exclude, polish = _problem(3)
    b1 = native_relax.relax(pos.copy(), constraints, exclude, 60, 0.04, 1.5,
                            polish)
    b2 = native_relax.relax(pos.copy(), constraints, exclude, 60, 0.04, 1.5,
                            polish)
    np.testing.assert_array_equal(b1, b2)
    for i, j, d in polish:
        assert abs(np.linalg.norm(b1[j] - b1[i]) - d) < 0.05, (i, j, d)


def test_library_in_the_ports_build_dir():
    """Built under agdiff_torch/data/build/, named by its source's hash,
    never in native/build/."""
    path = native_relax.build()
    assert os.path.dirname(path) == native_relax.BUILD_DIR
    assert os.path.basename(path).startswith("librelax-")
    assert not path.startswith(os.path.dirname(native_relax.SOURCE))


def test_bad_input_and_failed_build_raise(tmp_path, monkeypatch):
    pos, constraints, exclude, polish = _problem(0)
    with pytest.raises(ValueError, match="outside"):
        native_relax.relax(pos, [(0, 40, 1.5)], exclude, 2, 0.04, 1.5, None)
    with pytest.raises(ValueError, match="do not match"):
        native_relax.relax(pos[:5], constraints, exclude, 2, 0.04, 1.5,
                           None)
    bad = tmp_path / "relax.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_relax, "SOURCE", str(bad))
    monkeypatch.setattr(native_relax, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_relax, "_lib", None)
    with pytest.raises(RuntimeError, match="cannot build"):
        _relax(pos.copy(), constraints, exclude, iters=2, polish=polish)
    assert os.listdir(tmp_path / "build") == []
    out = _relax(pos.copy(), constraints, exclude, iters=2, polish=polish,
                 use_native=False)
    assert np.isfinite(out).all()
