"""llrs_ms.batch: ms per call of host time inside ft8.llrs (nested ranges excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "llrs")
