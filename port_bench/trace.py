"""Device traces of the window's calls, reduced as each call ends.

`CallTrace` is a context manager around one call into the program:
torch.profiler records the host's ops and every device operation
(kernels, copies, sets; those a CUDA graph replays among them), and on
exit the events are reduced to `result`:
- `window_s`: the call's host span, from entering to leaving;
- `busy_s`: the union of the device operations' intervals inside it;
- `ops`: {device operation name: seconds};
- `gaps`: {what the host was doing: seconds of device idle}, each idle
  interval of the device of at least GAP_NS within the call put under
  the innermost host op that covers its middle ("host, no op" where none
  does), the shorter ones together under "between device ops".
Only sums are kept, so a long call costs its events' reduction once.
"""

from __future__ import annotations

import time
from collections import defaultdict

GAP_NS = 20_000
SPAN = "port_bench.call"


def _ns(ev, what):
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return f()
    return getattr(ev, what + "_us")() * 1000


def reduce_events(events, t0_ns: int, t1_ns: int) -> dict:
    """Reduce profiler events (name, device?, start ns, end ns) to the
    busy union, per-op sums and idle gaps over [t0_ns, t1_ns]."""
    dev, host = [], []
    for name, on_device, start, end in events:
        (dev if on_device else host).append((start, end, name))
    dev.sort()
    ops = defaultdict(float)
    busy, spans = 0, []
    cur_s = cur_e = None
    for start, end, name in dev:
        ops[name] += (end - start) / 1e9
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                spans.append((cur_s, cur_e))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        spans.append((cur_s, cur_e))
    busy = sum(e - s for s, e in spans)
    idle = []
    edge = t0_ns
    for s, e in spans:
        if s > edge:
            idle.append((edge, s))
        edge = max(edge, e)
    if t1_ns > edge:
        idle.append((edge, t1_ns))
    host.sort(key=lambda h: h[1] - h[0])
    gaps = defaultdict(float)
    for s, e in idle:
        if e - s < GAP_NS:
            gaps["between device ops"] += (e - s) / 1e9
            continue
        mid = (s + e) // 2
        label = "host, no op"
        for hs, he, name in host:     # shortest first: the innermost
            if hs <= mid <= he:
                label = name
                break
        gaps[label] += (e - s) / 1e9
    return dict(window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy / 1e9,
                ops=dict(ops), gaps=dict(gaps))


class CallTrace:
    def __init__(self):
        self.result = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        import torch

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = torch.profiler.record_function(SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        raw = self.prof.profiler.kineto_results.events()
        events = []
        for ev in raw:
            start = _ns(ev, "start")
            events.append((ev.name(), ev.device_type() == DeviceType.CUDA,
                           start, start + _ns(ev, "duration")))
        del raw
        self.prof = None
        # the call's span on the profiler's clock
        span = [e for e in events if e[0] == SPAN and not e[1]]
        t0_ns, t1_ns = span[0][2], span[0][3]
        events = [e for e in events if e[0] != SPAN]
        self.result = reduce_events(events, t0_ns, t1_ns)
        self.result["host_window_s"] = (t1 - self.t0) / 1e9
        return False
