"""sync_z_ms.beacon: ms per call of host time inside ft8.sync_z, the stacked
linear Costas z statistic."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "sync_z")
