"""The native geometry relaxation (native/relax.cpp) through ctypes (port
of agdiff_tpu/data/native_relax.py).

data/synthetic.py `_relax` calls it by default: the rich chemistry's ring
closure and torsion moves relax through it, the same f64 math as the
numpy loop kept there as the parity reference (equal to ~1e-6).

The library is built with g++ at first use into this package's own build
directory, agdiff_torch/data/build/ (ignored by git), as
librelax-<hash>.so (utils/native_build.py), with the JAX package's flags
(-O3 -march=native, else -O3), so that on one machine both packages
compute the same bits. If g++ fails, or the library does not load,
`get_lib` raises: the port does not fall back to numpy, where the JAX
package does.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence

import numpy as np

from agdiff_torch.utils import native_build

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "relax.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
FLAGS = (["-O3", "-march=native"], ["-O3"])

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(source: Optional[str] = None) -> str:
    """The library of `source` (default SOURCE), compiled unless it is
    built already; raises RuntimeError with g++'s output if no flag set
    builds it."""
    return native_build.build_library(source or SOURCE, "relax", BUILD_DIR,
                                      FLAGS)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ip = ctypes.POINTER(ctypes.c_int)
            dp = ctypes.POINTER(ctypes.c_double)
            up = ctypes.POINTER(ctypes.c_ubyte)
            lib.agdiff_relax.restype = None
            lib.agdiff_relax.argtypes = [
                ctypes.c_int, dp,
                ctypes.c_int, ip, ip, dp,
                ctypes.c_int, ip, ip, dp,
                up, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ]
            _lib = lib
    return _lib


def _split(constraints: Sequence[tuple]):
    if len(constraints) == 0:
        z = np.zeros(0, np.int32)
        return z, z, np.zeros(0, np.float64)
    i, j, d = zip(*constraints)
    return (np.ascontiguousarray(i, np.int32),
            np.ascontiguousarray(j, np.int32),
            np.ascontiguousarray(d, np.float64))


def relax(pos: np.ndarray, constraints: List[tuple], exclude: np.ndarray,
          iters: int, step: float, repulse: float,
          polish: Optional[List[tuple]]) -> np.ndarray:
    """The native twin of synthetic._relax. As in the JAX package, a
    C-contiguous float64 `pos` is relaxed in place (and returned); any
    other is copied first."""
    lib = get_lib()
    p = np.ascontiguousarray(pos, np.float64)
    if p.shape != (len(exclude), 3) or np.shape(exclude) != (len(p), len(p)):
        raise ValueError(f"pos {p.shape} and exclude {np.shape(exclude)} "
                         f"do not match")
    ci, cj, cd = _split(constraints)
    pi, pj, pd = _split(polish if polish is not None else constraints)
    n = len(p)
    for idx in (ci, cj, pi, pj):
        if len(idx) and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"a constraint names an atom outside 0..{n - 1}")
    ex = np.ascontiguousarray(np.asarray(exclude).astype(np.uint8))
    doubles = ctypes.POINTER(ctypes.c_double)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.agdiff_relax(
        n, p.ctypes.data_as(doubles),
        len(ci), ci.ctypes.data_as(ints), cj.ctypes.data_as(ints),
        cd.ctypes.data_as(doubles),
        len(pi), pi.ctypes.data_as(ints), pj.ctypes.data_as(ints),
        pd.ctypes.data_as(doubles),
        ex.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        int(iters), float(step), float(repulse),
    )
    return p
