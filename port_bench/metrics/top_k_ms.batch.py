"""top_k_ms.batch: ms per call of host time inside ft8.top_k (nested ranges excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "top_k")
