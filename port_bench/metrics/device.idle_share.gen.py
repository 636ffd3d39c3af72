"""1 - the device's busy time (the union of its operations' intervals)
over the traced calls' spans."""


def read(reading):
    calls = reading["calls"]
    if not calls or any(c.get("trace") is None for c in calls):
        return None
    busy = sum(c["trace"]["busy_s"] for c in calls)
    span = sum(c["trace"]["window_s"] for c in calls)
    return 1.0 - busy / span if busy > 0 else None
