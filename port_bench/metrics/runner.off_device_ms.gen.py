"""Per `run` call of the window: the call's span minus the device's busy
time inside it (profiler), in ms; the mean over the calls."""


def read(reading):
    traces = [c.get("trace") for c in reading["calls"]]
    if not traces or None in traces:
        return None
    return sum((t["window_s"] - t["busy_s"]) * 1e3
               for t in traces) / len(traces)
