"""No module of the benchmark imports jax, jaxlib, flax or the JAX
package, and the reference imports nothing of the program: each import's
top-level name (before the first dot) compared whole."""

import ast
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "agdiff_tpu"}


def imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {p: JAX & set(imports(p)) for p in sources()}
    assert not {p: s for p, s in found.items() if s}
    assert len(found) > 10


def test_reference_imports_nothing_of_the_program():
    for p in sources("reference"):
        names = set(imports(p))
        assert "agdiff_torch" not in names and not (JAX & names), p
        assert names <= {"__future__", "math", "typing", "numpy", "torch"}, p


def test_top_level_names_compared_whole():
    # the port's name begins with the JAX package's: agdiff_torch is not it
    assert "agdiff_torch".split(".")[0] not in JAX
    assert "agdiff_tpu.models".split(".")[0] in JAX
