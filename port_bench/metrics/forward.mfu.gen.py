"""The model FLOPs of the window's forwards (port_bench/work, every
conformer's forward at every ladder step) over the seconds of the traced
calls, as a share of the card's peak at the configuration's dtype (%)."""

from port_bench import peaks


def read(reading):
    calls = reading["calls"]
    if not calls or any(c.get("trace") is None for c in calls):
        return None
    flops = sum(c["work"]["forward"].flops for c in calls)
    seconds = sum(c["trace"]["window_s"] for c in calls)
    return 100.0 * flops / seconds / peaks.FLOPS[reading["config"]["dtype"]]
