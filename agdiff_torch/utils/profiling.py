"""Profiling hooks (port of agdiff_tpu/utils/profiling.py):

* `trace(log_dir)`: torch.profiler over a block, its trace written under
  log_dir for TensorBoard or Perfetto;
* `Timer`: host wall-clock phase timing that waits for the CUDA work of
  what it is given;
* `device_memory_stats()`: a card's allocator counters under the JAX
  package's keys;
* `span(name)`: a named phase of the program, recorded only while a
  torch.profiler records: as a host range of the profiler, which puts it
  in the profiler's trace on the device's clock, and as a `Span` in
  memory (`spans()`), its parent the innermost span open on the same
  thread;
* `count(name, n)`: a counter, always on (`counters()`), bumped at
  per-call, per-capture or per-replay points only.

`clear()` empties the spans and the counters. The spans of the generation
path: `runner.run` (a runner's `run`) with `runner.plan`, `runner.pad`,
`runner.starts`, `ladder.run`, `runner.wait`, `runner.retry`,
`runner.copy_back` and `runner.collect` inside it; `ladder.run` (a
sampler's call) with `ladder.pairs`, `ladder.capture` and `forward`
inside it (the forward of a ladder step: every step when the ladder runs
eagerly, at capture only when it replays CUDA graphs); `kernels.build` (a
kernel's nvcc build and load). The counters: `ladder.replayed_nodes`,
`forward.replayed_nodes` and `ladder.replayed_steps`
(sampling/graphed.py), the graph nodes of each replayed block, the
forward's part of them, and its steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from agdiff_torch.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a block: `with trace('logs/profile'): step()`. Records CPU
    activity, and CUDA activity where a card is present; the trace
    (<worker>.<time>.pt.trace.json, tensorboard_trace_handler's) goes to
    log_dir when the block ends; the program's spans record inside it.
    Yields the profiler."""
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


class Span(NamedTuple):
    """One recorded span: times on time.perf_counter_ns; parent_id None
    for a root, whose id is the `request` its descendants share."""

    id: int
    parent_id: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    request: int


_spans: List[Span] = []
_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()
_ids = itertools.count(1)
_open = threading.local()   # .stack: this thread's open spans
# the profiler's range at function scope, an op on the host timeline
# alone: a torch.profiler.record_function range is a user annotation,
# which the profiler also draws on the device's timeline over the kernels
# launched inside it, so that a trace's device busy time would count it
_host_range = torch._C._profiler._RecordFunctionFast


class span:
    """`with span("runner.pad"): ...`, or `@span("runner.run")` on a
    function. Off (no profiler recording) it costs one attribute read."""

    __slots__ = ("name", "_range", "_id", "_parent", "_request", "_start")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if not _autograd_profiler._is_profiler_enabled:
            return self
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        self._id = next(_ids)
        self._parent = None if parent is None else parent._id
        self._request = self._id if parent is None else parent._request
        stack.append(self)
        self._range = _host_range(self.name)
        self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._range is None:
            return False
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._range = None
        _open.stack.pop()
        _spans.append(Span(self._id, self._parent, self.name, self._start,
                           end, self._request))
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


def count(name: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> List[Span]:
    """The spans recorded so far, each as it closed."""
    return list(_spans)


def counters() -> Dict[str, int]:
    with _counters_lock:
        return dict(_counters)


def clear() -> None:
    """Forget the recorded spans and the counters."""
    with _counters_lock:
        _spans.clear()
        _counters.clear()


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
