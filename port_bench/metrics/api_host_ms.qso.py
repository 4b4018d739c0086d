"""api_host_ms.qso: ms per capture of host time outside every ft8.<stage>
range: the host API's own work (argument handling, the copy in, the
hypotheses, the rows)."""


def read(t, ctx):
    return 1e3 * t.outside_host_s / t.calls if t.calls else None
