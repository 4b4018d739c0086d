"""osd_ms.beacon: ms per call of host time inside ft8.osd: OSD on the
candidates BP left, in the first pass and in the coherent retry's batch."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "osd")
