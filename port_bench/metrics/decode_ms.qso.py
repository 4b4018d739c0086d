"""decode_ms.qso: ms per capture of host time inside ft8.decode, BP + CRC
of the first pass and of every retry's batch (ft8.osd excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "decode")
