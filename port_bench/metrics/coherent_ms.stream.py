"""coherent_ms.stream: ms per call of host time inside ft8.coherent, the
five coherent branches' LLRs of the block's coherent retry (its BP + OSD
batch excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "coherent")
