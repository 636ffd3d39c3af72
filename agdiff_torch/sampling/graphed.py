"""The ladder as CUDA graphs: PyTorch's counterpart of the JAX sampler's
one `lax.scan` program a ladder, compiled ahead of time by the runner's
warm (agdiff_tpu/sampling/langevin.py:261-289, eval/generate.py:55-160).

A `LadderGraphs` captures each block of a ladder's plan
(sampling/langevin.py Ladder: BLOCK_STEPS steps, or traj_stride steps,
the steps left over, the denoise tail) once, and a run replays them in
the plan's order. The step function reads every per-step scalar on the
device through the ladder's step counter, so one captured block serves
every block of its size. What a graph bakes in as host values at
capture: the shapes, K1's ranks and layout levels, and the pair list's
host fields (`num_valid`, `inc_shift`, the length of `inc`). A tight
list is a molecule's own, so the graphs are keyed by the list's `key`
(ops/pairs.py) beside the batch shape; a run given another list raises.
The batch's fields and positions are copied into the ladder's static
tensors before the replays; each block's noise is drawn outside the
graph into a static buffer, as the eager loop draws it, so eager and
graphed runs give the same bits.

Capture follows PyTorch's CUDA-graph notes: the step functions first run
on a side stream, which fills every cache a first call fills (K1's packed
weights and cluster occupancy, K2-K4's prepared weights and the fused
kernels' resident-blocks query, K6's packed weights and scratch, the
pair list), then each block is captured on that stream into one memory
pool per ladder. A block's temporaries live in that pool, which the
blocks share (they replay one after another, and each block's results
are copied into the ladder's own tensors) and which lives as long as
the graphs. What a graph reads or writes outside the pool was made
before the capture: the ladder's tensors, the pair list and the
forward's weights, which the ladder holds, and the kernels' caches. Of
those, a cache that may later replace or drop its tensor (K6's scratch
grows by replacing it; fused.py keeps the newest 64 prepared weight
sets) has its tensors held by the graphs (kernels.holding), so a graph
never touches memory the allocator has freed. `pool_bytes` is the
device memory the captures reserved.

The kernel wrappers' launch counters move at capture only, where nothing
runs: `captured` counts the launches recorded into graphs and `replayed`
adds each replay's captured count, so that kernel_counts() - captured +
replayed is the launches recorded times their replays, not a count of
what ran; only a profile of the replays (chip_profile.py --graph) sees
the kernels run. A forward's `calls` likewise counts the forwards
captured times their replays.

The device operations a block replays are counted where it is captured:
the node count of the graph being captured, read from the CUDA driver
(`capture_nodes`) at the block's start and end and around each forward
inside it, gives `nodes[(kind, size)] = (total, forward)`, None where
libcuda cannot be asked. Each replay adds them to the counters
`ladder.replayed_nodes` and `forward.replayed_nodes`, and its steps to
`ladder.replayed_steps` (utils/profiling.py).
"""

from __future__ import annotations

import ctypes
import functools
import time
from collections import Counter
from typing import Dict, Optional, Tuple

import torch

from agdiff_torch import kernels
from agdiff_torch.kernels import block_packed, fused, monolithic
from agdiff_torch.kernels import stack_packed
from agdiff_torch.utils import profiling

# launches recorded into graphs, and each replay's recorded launches
# added up, as "<kernel module>/<variant>"
captured: Counter = Counter()
replayed: Counter = Counter()
WARM_UP = 2   # eager runs of each step kind before capture


def kernel_counts() -> Counter:
    """Every kernel wrapper's launch count, as "<module>/<variant>"."""
    out: Counter = Counter()
    for mod in (stack_packed, fused, block_packed, monolithic):
        name = mod.__name__.rsplit(".", 1)[1]
        for variant, n in mod.launches.items():
            out[f"{name}/{variant}"] += n
    return out


_CAPTURE_ACTIVE = 1   # CU_STREAM_CAPTURE_STATUS_ACTIVE


@functools.cache
def _cuda_driver() -> Optional[ctypes.CDLL]:
    """The CUDA driver with the two calls capture_nodes makes declared;
    None where it is missing or lacks them (no card, an old driver)."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        info, nodes = lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes
    except (OSError, AttributeError):
        return None
    info.restype = nodes.restype = ctypes.c_int
    info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_uint64),
                     ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_size_t)]
    nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.POINTER(ctypes.c_size_t)]
    return lib


def capture_nodes(stream: torch.cuda.Stream) -> Optional[int]:
    """The nodes of the graph being captured on `stream` so far; None
    where the stream is not capturing or libcuda cannot be asked."""
    lib = _cuda_driver()
    if lib is None:
        return None
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    if lib.cuStreamGetCaptureInfo_v2(
            stream.cuda_stream, ctypes.byref(status),
            ctypes.byref(ctypes.c_uint64()), ctypes.byref(graph),
            ctypes.byref(ctypes.c_void_p()),
            ctypes.byref(ctypes.c_size_t())) != 0 \
            or status.value != _CAPTURE_ACTIVE or not graph.value:
        return None
    n = ctypes.c_size_t()
    if lib.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        return None
    return n.value


class NodeTally:
    """The nodes a block's capture on `stream` adds inside forward calls:
    the ladder enters it around each forward while `Ladder.tally` is
    set; `forward` is None once a read failed."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream, self.forward = stream, 0

    def __enter__(self):
        self._before = capture_nodes(self.stream)
        return self

    def __exit__(self, *exc):
        after = capture_nodes(self.stream)
        if None in (self._before, after, self.forward):
            self.forward = None
        else:
            self.forward += after - self._before
        return False


class LadderGraphs:
    """The captured blocks of one Ladder (its forward, config, batch shape
    and pair list). `captured[(kind, size)]` holds each graph's launches
    and forwards, `nodes[(kind, size)]` its (total, forward) graph nodes
    or None; `capture_s` the seconds warm-up and capture took,
    `pool_bytes` the device memory the captures reserved. `captures`
    counts the ladders captured in this process (a server checks that
    none is captured while it answers requests)."""

    captures = 0

    def __init__(self, ladder, batch):
        LadderGraphs.captures += 1
        self.ladder = ladder
        self.key = None if ladder.pairs is None else ladder.pairs.key
        self.shape = tuple(batch.pos.shape)
        self.graphs: Dict[Tuple[str, int], torch.cuda.CUDAGraph] = {}
        self.captured: Dict[Tuple[str, int], Tuple[Counter, int]] = {}
        self.nodes: Dict[Tuple[str, int],
                         Optional[Tuple[int, int]]] = {}
        self.held = []
        self.pool_bytes = 0
        t0 = time.perf_counter()
        self._capture(batch)
        self.capture_s = time.perf_counter() - t0

    @torch.no_grad()
    @profiling.span("ladder.capture")
    def _capture(self, batch) -> None:
        ladder = self.ladder
        blocks = sorted({(kind, size) for kind, size, _, _ in ladder.plan})
        kinds = sorted({kind for kind, _ in blocks})
        stream = torch.cuda.Stream(device=batch.pos.device)
        stream.wait_stream(torch.cuda.current_stream(batch.pos.device))
        with torch.cuda.stream(stream):
            ladder.load(batch, batch.pos)
            for kind in kinds:
                for _ in range(WARM_UP):
                    ladder.counter.zero_()
                    ladder.block(kind, 1)
            pool = None
            # each capture empties the allocator's cache as it starts
            # (torch.cuda.graph); doing so here first leaves the pool's
            # segments as all the reserved memory the captures add
            torch.cuda.synchronize(batch.pos.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(batch.pos.device)
            for kind, size in blocks:
                graph = torch.cuda.CUDAGraph()
                counts0 = kernel_counts()
                calls0 = getattr(ladder.forward_fn, "calls", 0)
                tally = ladder.tally = NodeTally(stream)
                try:
                    with kernels.holding() as held, torch.cuda.graph(
                            graph, pool=pool, stream=stream):
                        start = capture_nodes(stream)
                        ladder.block(kind, size)
                        end = capture_nodes(stream)
                finally:
                    ladder.tally = None
                self.nodes[(kind, size)] = (
                    None if None in (start, end, tally.forward)
                    else (end - start, tally.forward))
                pool = graph.pool() if pool is None else pool
                self.held.extend(held)
                self.graphs[(kind, size)] = graph
                launched = kernel_counts() - counts0
                calls = getattr(ladder.forward_fn, "calls", 0) - calls0
                self.captured[(kind, size)] = (launched, calls)
                captured.update(launched)
                if calls:
                    ladder.forward_fn.calls -= calls
            self.pool_bytes = (torch.cuda.memory_reserved(batch.pos.device)
                               - reserved)
        torch.cuda.current_stream(batch.pos.device).wait_stream(stream)

    def replay(self, kind: str, size: int) -> None:
        self.graphs[(kind, size)].replay()
        launched, calls = self.captured[(kind, size)]
        replayed.update(launched)
        if calls:
            self.ladder.forward_fn.calls += calls
        nodes = self.nodes[(kind, size)]
        if nodes is not None:
            profiling.count("ladder.replayed_nodes", nodes[0])
            profiling.count("forward.replayed_nodes", nodes[1])
            profiling.count("ladder.replayed_steps", size)

    def run(self, batch, pairs, pos_init, generator=None, noise=None):
        """Replay the ladder on `batch`; raises for another batch shape or
        pair list than the captured one."""
        key = None if pairs is None else pairs.key
        if key != self.key or tuple(batch.pos.shape) != self.shape:
            raise ValueError(
                f"graphs captured for batch {self.shape} and pair list "
                f"{self.key} cannot run batch {tuple(batch.pos.shape)} with "
                f"pair list {key}")
        self.ladder.load(batch, pos_init)
        return self.ladder.run(generator, noise, replay=self.replay)
