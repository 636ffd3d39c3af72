"""Per `run` call of the window: the runner's own host work, in ms, the
mean over the calls. Read from the program's spans
(agdiff_torch/utils/profiling.py), which record only while the profiler
does, in the traced calls: each root span `runner.run` less what the
spans `ladder.run` (the sampler's call) and `runner.wait` (the host
waiting for the ladder's flags) under it cover."""

LADDER = ("ladder.run", "runner.wait")


def read(reading):
    from agdiff_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:     # a program without spans
        return None
    spans = spans()
    by_id = {s.id: s for s in spans}
    roots = {s.id: s for s in spans
             if s.parent_id is None and s.name == "runner.run"}
    if not roots or len(roots) < len(reading["calls"]):
        return None
    own = {i: s.end_ns - s.start_ns for i, s in roots.items()}
    for s in spans:
        if s.name not in LADDER:
            continue
        up = by_id.get(s.parent_id)
        while up is not None and up.name not in LADDER \
                and up.parent_id is not None:
            up = by_id.get(up.parent_id)
        if up is not None and up.id in roots:   # not inside another
            own[up.id] -= s.end_ns - s.start_ns
    return sum(own.values()) / len(own) / 1e6
