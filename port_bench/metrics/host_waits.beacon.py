"""host_waits.beacon: the program's waits for the card per call (its
``waits`` counter)."""

from port_bench.counters import per_call


def read(t, ctx):
    return per_call(t, "waits")
