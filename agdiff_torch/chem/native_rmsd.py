"""The native symmetry-aware RMSD (native/rmsd.cpp) through ctypes (port
of agdiff_tpu/chem/native_rmsd.py:78-134).

The library is built with g++ at first use (-O3 -march=native -fopenmp;
without the last two where the toolchain refuses them) into this
package's own build directory, agdiff_torch/chem/build/ (ignored by git),
as librmsd-<hash>.so (utils/native_build.py). If g++ fails, or the
library does not load, `get_lib` raises: chem/rmsd.py does not fall back
to numpy.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from agdiff_torch.chem.mol import Molecule
from agdiff_torch.utils import native_build

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "rmsd.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
FLAGS = (["-O3", "-march=native", "-fopenmp"], ["-O3"])

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(source: Optional[str] = None) -> str:
    """The library of `source` (default SOURCE), compiled unless it is
    built already; raises RuntimeError with g++'s output if no flag set
    builds it."""
    return native_build.build_library(source or SOURCE, "rmsd", BUILD_DIR,
                                      FLAGS)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ip = ctypes.POINTER(ctypes.c_int)
            dp = ctypes.POINTER(ctypes.c_double)
            lib.agdiff_enumerate_automorphisms.restype = ctypes.c_int
            lib.agdiff_enumerate_automorphisms.argtypes = [
                ctypes.c_int, ip, ip, ctypes.c_int, ip]
            lib.agdiff_rmsd_confusion.restype = None
            lib.agdiff_rmsd_confusion.argtypes = [
                ctypes.c_int, dp, ctypes.c_int, dp, ctypes.c_int, ip,
                ctypes.c_int, dp]
            lib.agdiff_best_rmsd.restype = ctypes.c_double
            lib.agdiff_best_rmsd.argtypes = [
                ctypes.c_int, dp, dp, ip, ctypes.c_int]
            _lib = lib
    return _lib


def _ints(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _doubles(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def enumerate_automorphisms(labels: np.ndarray, adj_type: np.ndarray,
                            max_maps: int = 10000) -> np.ndarray:
    """(num_perms, N) automorphisms of a labelled graph."""
    lib = get_lib()
    n = len(labels)
    labels = np.ascontiguousarray(labels, np.int32)
    adj = np.ascontiguousarray(adj_type, np.int32)
    out = np.zeros((max_maps, n), np.int32)
    count = lib.agdiff_enumerate_automorphisms(n, _ints(labels), _ints(adj),
                                               max_maps, _ints(out))
    return out[:count]


def rmsd_confusion_matrix(mol: Molecule, pos_refs: np.ndarray,
                          pos_gens: np.ndarray, strip_hydrogens: bool = True,
                          max_maps: int = 10000) -> np.ndarray:
    """The (num_ref, num_gen) symmetry-aware best-RMSD matrix."""
    from agdiff_torch.chem.rmsd import scored_graph

    lib = get_lib()
    keep, labels, adj = scored_graph(mol, strip_hydrogens)
    n = mol.num_nodes
    refs = np.asarray(pos_refs, np.float64).reshape(-1, n, 3)[:, keep]
    gens = np.asarray(pos_gens, np.float64).reshape(-1, n, 3)[:, keep]
    perms = np.ascontiguousarray(
        enumerate_automorphisms(labels, adj, max_maps=max_maps), np.int32)
    refs, gens = np.ascontiguousarray(refs), np.ascontiguousarray(gens)
    out = np.zeros((len(refs), len(gens)), np.float64)
    lib.agdiff_rmsd_confusion(len(labels), _doubles(refs), len(refs),
                              _doubles(gens), len(gens), _ints(perms),
                              len(perms), _doubles(out))
    return out


def best_rmsd(mol: Molecule, pos_ref: np.ndarray, pos_gen: np.ndarray,
              strip_hydrogens: bool = True, max_maps: int = 10000) -> float:
    return float(rmsd_confusion_matrix(
        mol, pos_ref[None], pos_gen[None], strip_hydrogens=strip_hydrogens,
        max_maps=max_maps)[0, 0])
