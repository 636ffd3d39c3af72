"""g++ builds of the host-side C++ sources under native/ (rmsd.cpp for
chem/native_rmsd.py, relax.cpp for data/native_relax.py).

A library is built at first use into a directory of this package (ignored
by git), named lib<stem>-<hash>.so after a digest of its source, so an
edited source builds anew; the JAX package's native/build/ is not touched.
A build writes a temporary file and renames it, so that processes building
at once never load a half-written library. Each source has its own flag
sets, tried in order; if none builds, the build raises with g++'s output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Sequence


def library_path(source: str, stem: str, build_dir: str) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(build_dir, f"lib{stem}-{digest}.so")


def build_library(source: str, stem: str, build_dir: str,
                  flag_sets: Sequence[Sequence[str]]) -> str:
    """The library of `source`, compiled with the first flag set that
    builds unless it is built already; raises RuntimeError with g++'s
    output if none does."""
    out = library_path(source, stem, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    logs = []
    try:
        for flags in flag_sets:
            try:
                proc = subprocess.run(
                    ["g++", *flags, "-shared", "-fPIC", "-std=c++17",
                     source, "-o", tmp], capture_output=True, text=True)
            except FileNotFoundError as err:
                raise RuntimeError(f"g++ not found: {err}") from err
            if proc.returncode == 0:
                os.replace(tmp, out)
                return out
            logs.append(f"g++ {' '.join(flags)}: {proc.stderr}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    raise RuntimeError(f"cannot build {source}:\n" + "\n".join(logs))
