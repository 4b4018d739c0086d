"""osd_ms.qso: ms per capture of host time inside ft8.osd, OSD on the valid
rows BP left, in the first pass and in every retry's batch."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "osd")
