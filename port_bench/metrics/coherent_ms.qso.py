"""coherent_ms.qso: ms per capture of host time inside ft8.coherent, the
five coherent branches' LLRs of the a-priori coherent retry (its BP + OSD
batch excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "coherent")
