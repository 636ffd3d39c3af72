"""K1 (the whole-stack kernel, `stack_kernel` in the trace): the least
time its launches could take, each the larger of its FLOPs over the peak
at the configuration's dtype and its bytes over the HBM's rate
(port_bench/work), over K1's device time in the trace (%)."""

from port_bench import peaks

KERNEL = "stack_kernel"


def read(reading):
    calls = reading["calls"]
    if not calls or any(c.get("trace") is None for c in calls):
        return None
    least = 0.0
    for c in calls:
        k1 = c["work"]["k1"]
        least += c["work"]["launches"] * max(
            k1.flops / peaks.FLOPS[reading["config"]["dtype"]],
            k1.bytes / peaks.HBM_BYTES_PER_S)
    seconds = sum(v for c in calls for k, v in c["trace"]["ops"].items()
                  if KERNEL in k)
    return 100.0 * least / seconds if seconds > 0 else None
