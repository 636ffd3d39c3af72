"""Build a CUDA source under csrc/ with nvcc and load it with ctypes.

`csrc/<name>.cu` has a plain C interface and is compiled into
`build/lib<name>-<hash>.so`. The hash is of the source and of every file
it includes from csrc/ (`#include "..."`, followed to any depth), so an
edit to a shared header rebuilds each library that includes it.
`nvcc -gencode arch=compute_90a,code=sm_90a` targets Hopper; nothing
includes PyTorch's headers, so a build takes seconds. Nothing is built
when a module is imported: the first launch builds, under the span
`kernels.build` (utils/profiling.py) with the library's load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, List, Sequence

from agdiff_torch.utils.profiling import span

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc_path() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from agdiff_torch/kernels/csrc at first use")


def sources(name: str) -> List[str]:
    """csrc/<name>.cu and the files it includes from csrc/, to any depth,
    each once, in the order first met."""
    seen: List[str] = []
    todo = [os.path.join(CSRC, f"{name}.cu")]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path) as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            cand = os.path.join(os.path.dirname(path), inc)
            if os.path.exists(cand):
                todo.append(os.path.normpath(cand))
    return seen


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in sources(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc on csrc/<name>.cu into a temporary file; None when the
    library is built already."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                             os.path.join(CSRC, f"{name}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc exit {proc.returncode} on {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless it is built already; returns nvcc's
    output ("" when nothing was built) and raises if nvcc fails."""
    return _finish(name, _start(name))


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile several sources at once, one nvcc process each, all started
    together; returns each one's nvcc output and raises if any fails."""
    started = {name: _start(name) for name in names}
    logs, errors = {}, []
    for name, s in started.items():   # wait for every one before raising
        try:
            logs[name] = _finish(name, s)
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with span("kernels.build"):
            build(name)
            lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
