"""host_waits.stream: the program's waits for the card per call (its
``waits`` counter): the block's OSD count and result read-back among
them."""

from port_bench.counters import per_call


def read(t, ctx):
    return per_call(t, "waits")
