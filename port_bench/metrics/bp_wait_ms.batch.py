"""bp_wait_ms.batch: ms per call of host time inside ft8.decode.wait, where BP + CRC wait
for the card (the all-halted read of each BP iteration)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "decode.wait")
