"""buffer_ms.stream: ms per call (15 s of stream) of host time inside
ft8.buffer: each feed's append to the pending buffer, and each block's
slice, zero pad and upload."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "buffer")
