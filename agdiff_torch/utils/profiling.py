"""Profiling hooks (port of agdiff_tpu/utils/profiling.py):

* `trace(log_dir)`: torch.profiler over a block, its trace written under
  log_dir for TensorBoard or Perfetto;
* `Timer`: host wall-clock phase timing that waits for the CUDA work of
  what it is given;
* `device_memory_stats()`: a card's allocator counters under the JAX
  package's keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import torch

from agdiff_torch.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a block: `with trace('logs/profile'): step()`. Records CPU
    activity, and CUDA activity where a card is present; the trace
    (<worker>.<time>.pt.trace.json, tensorboard_trace_handler's) goes to
    log_dir when the block ends. Yields the profiler."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), found)
    return found


class Timer:
    """Wall-clock phase timer that waits for device work.

    with Timer() as t:
        out = step(...)
        t.block_on(out)
    print(t.elapsed)
    """

    def __enter__(self):
        self.start = time.perf_counter()
        self.elapsed = None
        return self

    def block_on(self, tree):
        """Wait for every CUDA device that holds a tensor of `tree` (nested
        dicts, lists, tuples and dataclasses; other leaves are ignored)
        to finish its queued work, a replayed CUDA graph's included."""
        for device in _cuda_devices(tree, set()):
            torch.cuda.synchronize(device)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """bytes_in_use, peak_bytes_in_use (the caching allocator's allocated
    bytes, now and at their peak) and bytes_limit (the card's memory) of a
    CUDA device; None for the CPU, which reports nothing, as JAX's CPU
    device does. device None is the first card, and raises where there
    is none."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}
