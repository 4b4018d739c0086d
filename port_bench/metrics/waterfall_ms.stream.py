"""waterfall_ms.stream: ms per call of host time inside ft8.waterfall, the
block's float64 dB waterfall (ops/waterfall.py waterfall_real)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "waterfall")
