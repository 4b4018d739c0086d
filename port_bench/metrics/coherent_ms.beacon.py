"""coherent_ms.beacon: ms per call of host time inside ft8.coherent, the
stacked coherent retry's LLR variants (its BP + OSD batch excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "coherent")
