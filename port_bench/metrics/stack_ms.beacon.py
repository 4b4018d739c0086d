"""stack_ms.beacon: ms per call of host time inside ft8.stack: the ring's
conversion, the repeats' block spectra, equalised powers and stacked grid
(the ring's upload excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "stack")
