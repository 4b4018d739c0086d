"""decode_ms.beacon: ms per call of host time inside ft8.decode, BP + CRC
(K7) on the first pass's candidates and on the coherent retry's variants
(ft8.osd excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "decode")
