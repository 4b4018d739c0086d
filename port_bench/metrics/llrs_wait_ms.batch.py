"""llrs_wait_ms.batch: ms per call of host time inside ft8.llrs.wait, where the LLR
gathers wait for the card (the copies of host index tables)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "llrs.wait")
