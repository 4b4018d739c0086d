"""decode_ms.stream: ms per call of host time inside ft8.decode, BP + CRC
of the block's first pass and of every retry's batch (ft8.osd excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "decode")
