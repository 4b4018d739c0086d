"""api_host_ms.stream: ms per call of host time outside every ft8.<stage>
range: the feed loop and the session's own bookkeeping."""


def read(t, ctx):
    return 1e3 * t.outside_host_s / t.calls if t.calls else None
