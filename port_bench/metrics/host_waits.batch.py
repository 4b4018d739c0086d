"""host_waits.batch: the program's waits for the card per call (its ``waits`` counter):
reads of card values and copies from pageable host memory."""

from port_bench.counters import per_call


def read(t, ctx):
    return per_call(t, "waits")
