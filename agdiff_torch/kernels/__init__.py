"""Hand-written Hopper kernels of the port and their wrappers.

Each kernel module holds the wrapper (which launches the CUDA kernel for
CUDA tensors and runs the plain PyTorch version for CPU tensors), the plain
version itself, and a launch counter. Sources are under csrc/ and are built
by build.py at first use.
"""

from contextlib import contextmanager
from typing import Iterator, List, Optional

# the cached tensors kernel launches pass while `holding` collects them
_held: Optional[List] = None


def hold(*tensors) -> None:
    """Note the tensors a launch takes from a cache that may later replace
    or drop them (K6's scratch, which grows by replacing its tensor; the
    prepared weights of K2-K4, of which fused.py keeps the newest 64),
    while `holding` is active: a CUDA graph that captures the launch keeps
    them alive, so it never writes or reads memory the allocator has
    freed. A launch's temporaries are not noted: the capture allocates
    them in the graph's own pool, which lives as long as the graph, and
    holding them would keep the pool from reusing them step to step."""
    if _held is not None:
        _held.extend(t for t in tensors if t is not None)


@contextmanager
def holding() -> Iterator[List]:
    """Collect the cached tensors of every launch made inside the block."""
    global _held
    outer, _held = _held, []
    try:
        yield _held
    finally:
        _held = outer
