"""The device operations (CUDA graph nodes) a replayed ladder step holds
outside the forward: the drift assembly and the update. Read from the
program's counters (agdiff_torch/utils/profiling.py, counted at capture
and added at each replay by sampling/graphed.py): ladder.replayed_nodes
less forward.replayed_nodes, over ladder.replayed_steps. Set-up captures
and does not replay, so they are the window's."""


def read(reading):
    from agdiff_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:     # a program without counters
        return None
    c = counters()
    steps = c.get("ladder.replayed_steps", 0)
    if not steps:
        return None
    return (c["ladder.replayed_nodes"] - c["forward.replayed_nodes"]) / steps
