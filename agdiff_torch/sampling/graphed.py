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
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, Tuple

import torch

from agdiff_torch import kernels
from agdiff_torch.kernels import block_packed, fused, monolithic
from agdiff_torch.kernels import stack_packed

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


class LadderGraphs:
    """The captured blocks of one Ladder (its forward, config, batch shape
    and pair list). `captured[(kind, size)]` holds each graph's launches
    and forwards; `capture_s` the seconds warm-up and capture took,
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
        self.held = []
        self.pool_bytes = 0
        t0 = time.perf_counter()
        self._capture(batch)
        self.capture_s = time.perf_counter() - t0

    @torch.no_grad()
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
                with kernels.holding() as held, torch.cuda.graph(
                        graph, pool=pool, stream=stream):
                    ladder.block(kind, size)
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
