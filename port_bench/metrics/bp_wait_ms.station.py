"""bp_wait_ms.station: ms per capture of host time inside ft8.decode.wait, where BP + CRC
wait for the card (the all-halted reads, the CRC matrix copy)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "decode.wait")
