"""refine_ms.qso: ms per capture of host time inside ft8.mf_refine, the
refined matched filter's 5 x 3 sub-grid offset search and its base and
refined LLRs (their BP + OSD batches excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "mf_refine")
