"""osd_ms.batch: ms per call of host time inside ft8.osd."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "osd")
