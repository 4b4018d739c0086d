"""decode_ms.batch: ms per call of host time inside ft8.decode, BP + CRC (ft8.osd excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "decode")
