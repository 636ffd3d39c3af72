"""K1's device time (`stack_kernel` in the trace) over the device's busy
time in the window's calls."""

KERNEL = "stack_kernel"


def read(reading):
    calls = reading["calls"]
    if not calls or any(c.get("trace") is None for c in calls):
        return None
    busy = sum(c["trace"]["busy_s"] for c in calls)
    k1 = sum(v for c in calls for k, v in c["trace"]["ops"].items()
             if KERNEL in k)
    return k1 / busy if busy > 0 and k1 > 0 else None
