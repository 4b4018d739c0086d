"""api_host_ms.beacon: ms per call of host time outside every ft8.<stage>
range: the session's own work (the feeds' buffer, the ring, dedup, times)."""


def read(t, ctx):
    return 1e3 * t.outside_host_s / t.calls if t.calls else None
