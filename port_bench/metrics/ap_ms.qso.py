"""ap_ms.qso: ms per capture of host time inside ft8.ap and outside the
spans nested in it: the a-priori retries' clamps, variant selection and
merges (their LLRs, coherent branches and BP + OSD batches excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "ap")
